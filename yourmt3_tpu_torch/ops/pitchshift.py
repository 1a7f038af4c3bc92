"""On-device pitch-shift augmentation (train-time).

Phase vocoder: STFT → time-stretch by r = 2^(-s/12) with phase
accumulation → ISTFT (windowed overlap-add) → linear resample back to the
original length, so the pitch moves by s semitones and the duration
stays. The STFT and its inverse are torch.fft calls, as the reference
leaves them to XLA's FFT.

The candidate semitone set is fixed; `batched_pitch_shift` computes every
candidate and picks one per example, so every shape is static. Label
pitches are shifted on the host with the same per-example semitone
(data/dataset_train.py).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .frontend import hann_window

DEFAULT_SEMITONES: Tuple[int, ...] = (-2, -1, 0, 1, 2)


def _window(n_fft: int, device) -> torch.Tensor:
    return torch.tensor(hann_window(n_fft), dtype=torch.float32, device=device)


def _frame_index(T: int, n_fft: int, hop: int, device) -> torch.Tensor:
    return (torch.arange(T, device=device)[:, None] * hop
            + torch.arange(n_fft, device=device)[None, :])


def _stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, L) → complex (B, T, n_fft//2+1), center-padded."""
    pad = n_fft // 2
    xp = torch.nn.functional.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]
    T = 1 + (xp.shape[1] - n_fft) // hop
    frames = xp[:, _frame_index(T, n_fft, hop, x.device)]
    return torch.fft.rfft(frames * _window(n_fft, x.device), dim=-1)


def _istft(spec: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """complex (B, T, F) → (B, length) via windowed overlap-add."""
    B, T, _ = spec.shape
    win = _window(n_fft, spec.device)
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * win
    out_len = (T - 1) * hop + n_fft
    idx = _frame_index(T, n_fft, hop, spec.device).reshape(-1)
    out = torch.zeros((B, out_len), dtype=torch.float32, device=spec.device)
    out.index_add_(1, idx, frames.reshape(B, -1))
    wsum = torch.zeros(out_len, dtype=torch.float32, device=spec.device)
    wsum.index_add_(0, idx, (win * win).repeat(T))
    out = out / torch.clamp(wsum, min=1e-8)[None]
    pad = n_fft // 2
    out = out[:, pad:pad + length]
    if out.shape[1] < length:
        out = torch.nn.functional.pad(out, (0, length - out.shape[1]))
    return out


def _phase_vocoder(spec: torch.Tensor, rate: float, hop: int,
                   n_fft: int) -> torch.Tensor:
    """Stretch a complex STFT in time by `rate` (static output length)."""
    B, T, F = spec.shape
    dev = spec.device
    T_out = max(2, int(np.floor(T / rate)))
    omega = torch.tensor(2.0 * np.pi * hop * np.arange(F) / n_fft,
                         dtype=torch.float32, device=dev)
    steps = torch.tensor(np.arange(T_out) * rate, dtype=torch.float32, device=dev)
    lo = torch.clamp(torch.floor(steps).long(), 0, T - 2)
    frac = steps - lo.to(torch.float32)
    s0, s1 = spec[:, lo, :], spec[:, lo + 1, :]
    mag = ((1 - frac)[None, :, None] * s0.abs()
           + frac[None, :, None] * s1.abs())
    dphi = s1.angle() - s0.angle() - omega[None, None, :]
    dphi = dphi - 2 * np.pi * torch.round(dphi / (2 * np.pi))
    dphi = dphi + omega[None, None, :]
    phase0 = s0[:, 0, :].angle()
    phase = phase0[:, None, :] + torch.cat(
        [torch.zeros((B, 1, F), device=dev), torch.cumsum(dphi[:, :-1, :], dim=1)],
        dim=1)
    return torch.polar(mag, phase)


def _linear_resample(x: torch.Tensor, out_len: int) -> torch.Tensor:
    """(B, L) → (B, out_len) linear interpolation over the full span."""
    L = x.shape[1]
    pos = torch.tensor(np.linspace(0, L - 1, out_len), dtype=torch.float32,
                       device=x.device)
    lo = torch.clamp(torch.floor(pos).long(), 0, L - 2)
    frac = pos - lo.to(torch.float32)
    return x[:, lo] * (1 - frac)[None] + x[:, lo + 1] * frac[None]


def pitch_shift_fixed(audio: torch.Tensor, semitones: int,
                      n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """(B, L) → (B, L), pitch moved by `semitones`."""
    if semitones == 0:
        return audio
    L = audio.shape[1]
    rate = float(2.0 ** (-semitones / 12.0))  # stretch factor in the PV domain
    stretched = _phase_vocoder(_stft(audio.to(torch.float32), n_fft, hop),
                               rate, hop, n_fft)
    y_len = (stretched.shape[1] - 1) * hop + n_fft
    y = _istft(stretched, n_fft, hop, y_len - n_fft)
    return _linear_resample(y, L)


def batched_pitch_shift(audio: torch.Tensor, shift_idx: torch.Tensor,
                        semitones: Sequence[int] = DEFAULT_SEMITONES,
                        n_fft: int = 1024, hop: int = 256) -> torch.Tensor:
    """Per-example shift: audio (B, L), shift_idx (B,) into `semitones`.
    Every candidate is computed, then each example takes its own."""
    cands = torch.stack([pitch_shift_fixed(audio, s, n_fft, hop)
                         for s in semitones], dim=0)  # (S, B, L)
    rows = torch.arange(audio.shape[0], device=audio.device)
    return cands[shift_idx.long().to(audio.device), rows]
