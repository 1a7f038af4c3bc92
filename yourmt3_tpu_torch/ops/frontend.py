"""Audio frontend: segment framing → STFT → (mel) → log.

Semantics of the reference frontend: center=True reflect padding,
periodic Hann window, HTK mel scale, magnitude (power=1.0) spectrogram.
The STFT is a GEMM against precomputed rFFT bases with the window folded
in, so framing is a block gather (hop divides n_fft) and the rest is
three matrix products in fp32. TF32 is never enabled for these products.
`use_pallas=True` routes a log-mel frontend through the fused kernel
(ops/fused_logmel.py), which keeps the frames and spectra on chip.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..config.audio import AudioConfig


# ---------------------------------------------------------------------------
# Host-side constant builders (numpy, run once at model build)
# ---------------------------------------------------------------------------

def hann_window(n: int, periodic: bool = True) -> np.ndarray:
    m = n if periodic else n - 1
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / m)


def rfft_basis(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """(n_fft, n_bins) cos and -sin DFT bases: X[f] = Σ_t x[t]·e^{-2πi tf/N}."""
    t = np.arange(n_fft)[:, None]
    f = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * t * f / n_fft
    return np.cos(ang), -np.sin(ang)


def hz_to_mel(f: np.ndarray, htk: bool = True) -> np.ndarray:
    if htk:
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)
    f = np.asarray(f, dtype=np.float64)
    mel = f / (200.0 / 3.0)
    log_region = f >= 1000.0
    return np.where(log_region,
                    15.0 + np.log(np.maximum(f, 1e-9) / 1000.0) / (np.log(6.4) / 27.0),
                    mel)


def mel_to_hz(m: np.ndarray, htk: bool = True) -> np.ndarray:
    if htk:
        return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)
    m = np.asarray(m, dtype=np.float64)
    f = m * (200.0 / 3.0)
    log_region = m >= 15.0
    return np.where(log_region, 1000.0 * np.exp((m - 15.0) * (np.log(6.4) / 27.0)), f)


def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float, f_max: float, htk: bool = True,
                   norm: Optional[str] = None) -> np.ndarray:
    """(n_freqs, n_mels) triangular filterbank (torchaudio semantics)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(hz_to_mel(np.array(f_min), htk),
                        hz_to_mel(np.array(f_max), htk), n_mels + 2)
    f_pts = mel_to_hz(m_pts, htk)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2:n_mels + 2] - f_pts[:n_mels])
        fb *= enorm[None, :]
    return fb


# ---------------------------------------------------------------------------
# Device-side frontend
# ---------------------------------------------------------------------------

class SpectrogramFrontend(nn.Module):
    """(B, input_frames) float32 audio → (B, T, F) float32 log features.

    The window-folded DFT bases and the mel filterbank are buffers, so
    `.to(device)` moves them with the module. With `use_pallas` (the JAX
    package's name for the switch) a log-mel frontend runs the fused
    kernel (ops/fused_logmel.py): CUDA inputs launch it, CPU inputs take
    its plain version. The "spec" codec has no filterbank and never takes
    the kernel."""

    def __init__(self, cfg: AudioConfig, device=None, use_pallas: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.use_pallas = use_pallas
        n_bins = cfg.n_fft // 2 + 1
        cos_b, sin_b = rfft_basis(cfg.n_fft)
        win = hann_window(cfg.n_fft)
        f32 = dict(dtype=dtype, device=device)
        self.register_buffer("window", torch.tensor(win, **f32))
        self.register_buffer("basis_cos", torch.tensor(cos_b * win[:, None], **f32))
        self.register_buffer("basis_sin", torch.tensor(sin_b * win[:, None], **f32))
        mel = None
        if cfg.codec == "melspec":
            mel = torch.tensor(
                mel_filterbank(n_bins, cfg.n_mels, cfg.sample_rate, cfg.f_min,
                               cfg.f_max, cfg.mel_htk, cfg.mel_norm), **f32)
        self.register_buffer("mel_fb", mel)
        self._packed = None  # the kernel's layout of the bases, made at first use

    @classmethod
    def from_config(cls, cfg: AudioConfig, dtype: torch.dtype = torch.float32,
                    use_pallas: bool = False, device=None) -> "SpectrogramFrontend":
        return cls(cfg, device=device, use_pallas=use_pallas, dtype=dtype)

    def frame(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, input_frames) → (B, T, n_fft) via reflect-pad + block gather."""
        cfg = self.cfg
        pad = cfg.n_fft // 2
        x = torch.nn.functional.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]
        hop = cfg.hop_length
        blocks_per_frame = cfg.n_fft // hop  # requires hop | n_fft
        total = x.shape[1]
        n_blocks = -(-total // hop)
        x = torch.nn.functional.pad(x, (0, n_blocks * hop - total))
        blocks = x.reshape(x.shape[0], n_blocks, hop)
        idx = (torch.arange(cfg.num_frames, device=x.device)[:, None]
               + torch.arange(blocks_per_frame, device=x.device)[None, :])
        frames = blocks[:, idx]  # (B, T, bpf, hop)
        return frames.reshape(audio.shape[0], cfg.num_frames, cfg.n_fft)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        """(B, input_frames) or (B, 1, input_frames) → (B, T, F) float32."""
        if audio.ndim == 3:
            audio = audio[:, 0, :]
        audio = audio.to(torch.float32)
        if self.use_pallas and self.mel_fb is not None:
            return self._fused(audio)
        frames = self.frame(audio)
        re = torch.matmul(frames, self.basis_cos)
        im = torch.matmul(frames, self.basis_sin)
        mag = torch.sqrt(re * re + im * im + 1e-12)
        if self.cfg.power == 2.0:
            mag = mag * mag
        if self.mel_fb is not None:
            mag = torch.matmul(mag, self.mel_fb)
        return torch.log(torch.clamp(mag, min=self.cfg.log_offset))

    def _fused(self, audio: torch.Tensor) -> torch.Tensor:
        from .fused_logmel import fused_logmel, pack_bases
        args = (self.basis_cos, self.basis_sin, self.mel_fb)
        if audio.device.type != "cuda":
            return fused_logmel(audio, *args, self.cfg)
        if self._packed is None or self._packed[0].device != audio.device:
            self._packed = pack_bases(*args)
        return fused_logmel(audio, *args, self.cfg, packed=self._packed)
