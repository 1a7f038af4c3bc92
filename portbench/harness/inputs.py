"""Inputs made from the seed: songs for transcription, batches for
training. Every seed gets the same sizes; only the content differs.

`sine_song` is the seeded sine mixture of chip_smoke.py: a noise floor
and `tones` enveloped partials, each starting at a random time.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed, stream])


def sine_song(gen: np.random.Generator, seconds: float, sr: int, tones: int,
              amplitude: float, noise: float, f_lo: float, f_hi: float) -> np.ndarray:
    t = np.arange(int(round(seconds * sr))) / sr
    audio = noise * gen.standard_normal(t.shape)
    for f0 in gen.uniform(f_lo, f_hi, size=tones):
        start = gen.uniform(0, seconds * 0.8)
        env = np.clip((t - start) * 20.0, 0, 1) * np.exp(-np.clip(t - start, 0, None))
        audio += amplitude * env * np.sin(2 * np.pi * f0 * t)
    return audio.astype(np.float32)


def songs(seed: int, traffic: dict, sr: int) -> List[np.ndarray]:
    g = rng(seed, 1)
    return [sine_song(g, traffic["song_seconds"], sr, **traffic["tones"])
            for _ in range(traffic["songs"])]


def segments(audio: np.ndarray, frames: int) -> np.ndarray:
    """(samples,) → (N, frames) zero-padded non-overlapping segments."""
    n = max(1, -(-max(len(audio) - frames, 0) // frames) + 1)
    out = np.zeros((n, frames), np.float32)
    for i in range(n):
        chunk = audio[i * frames: (i + 1) * frames]
        out[i, :len(chunk)] = chunk
    return out


def write_float_wav(path: str, audio: np.ndarray, sr: int) -> None:
    """Mono IEEE-float WAV, so that the program reads the samples exactly."""
    data = np.asarray(audio, "<f4").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + (36 + len(data)).to_bytes(4, "little") + b"WAVE")
        f.write(b"fmt " + (16).to_bytes(4, "little")
                + (3).to_bytes(2, "little") + (1).to_bytes(2, "little")
                + sr.to_bytes(4, "little") + (4 * sr).to_bytes(4, "little")
                + (4).to_bytes(2, "little") + (32).to_bytes(2, "little"))
        f.write(b"data" + len(data).to_bytes(4, "little") + data)


def train_batches(seed: int, traffic: dict, frames: int, channels: int,
                  length: int, vocab: int, sr: int) -> List[Dict[str, np.ndarray]]:
    """`pool` batches of `batch_size` distinct rows: audio segments of sine
    mixtures, and per channel a label stream of random event ids (3 ..
    vocab-1) closed by EOS (1) and padded (0). A channel is active with
    probability `active_share` and then holds a length drawn from
    `active_tokens`, else only its EOS."""
    g = rng(seed, 2)
    B = traffic["batch_size"]
    lo, hi = traffic["active_tokens"]
    out = []
    for _ in range(traffic["pool"]):
        audio = np.stack([sine_song(g, frames / sr, sr, **traffic["tones"])[:frames]
                          for _ in range(B)])
        n = np.where(g.random((B, channels)) < traffic["active_share"],
                     g.integers(lo, hi + 1, (B, channels)), 0)
        ids = g.integers(3, vocab, (B, channels, length))
        pos = np.arange(length)[None, None, :]
        labels = np.where(pos < n[..., None], ids, np.where(pos == n[..., None], 1, 0))
        out.append({"audio": audio.astype(np.float32), "labels": labels.astype(np.int32)})
    return out
