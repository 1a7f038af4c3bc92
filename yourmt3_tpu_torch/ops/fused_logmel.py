"""Fused log-mel frontend: the CUDA kernel's wrapper and its plain
PyTorch version.

    frames (B, T, n_fft) from the reflect-padded audio row
    re, im = frames @ basis_cos, frames @ basis_sin   (window folded in)
    mag    = sqrt(re² + im² + 1e-12)                  (squared if power == 2)
    out    = log(max(mag @ mel_fb, log_offset))       → (B, T, n_mels)

`fused_logmel` launches the hand-written kernel (`csrc/fused_logmel.cu`,
bound as the PyTorch operator `torch.ops.yourmt3_tpu_torch.fused_logmel`)
for CUDA tensors, which keeps the frames and the spectra on chip, and
runs `fused_logmel_plain` for CPU tensors; it never falls back from one
to the other. The reflect padding stays a torch op inside the operator,
as the reference leaves it to XLA.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config.audio import AudioConfig
from . import cuda_build

# the kernel's LOGMEL_FREQ_TILE and LOGMEL_DFT_BLOCK (csrc/kernels.h)
FREQ_TILE = 128  # bins per frequency tile
DFT_BLOCK = 32  # samples per partial DFT sum


def reflect_pad(audio: torch.Tensor, n_fft: int) -> torch.Tensor:
    """(B, L) → (B, L + n_fft): center padding by n_fft/2 on each side."""
    pad = n_fft // 2
    return F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]


def fused_logmel_plain(audio: torch.Tensor, basis_cos: torch.Tensor,
                       basis_sin: torch.Tensor, mel_fb: torch.Tensor,
                       cfg: AudioConfig) -> torch.Tensor:
    """The kernel's function in plain PyTorch, with its arithmetic: fp32
    products, and the DFT sums taken in two levels, one matrix product
    per DFT_BLOCK samples added to the totals. (One fp32 product over all
    n_fft samples drifts by up to ~1e-3 in log-mel next to a loud tone.)"""
    T, n_fft, hop = cfg.num_frames, cfg.n_fft, cfg.hop_length
    x = reflect_pad(audio.to(torch.float32), n_fft)
    need = (T - 1) * hop + n_fft
    if x.shape[1] < need:
        x = F.pad(x, (0, need - x.shape[1]))
    frames = x.unfold(1, n_fft, hop)[:, :T]  # (B, T, n_fft) view
    re = im = 0.0
    for n0 in range(0, n_fft, DFT_BLOCK):
        part = frames[..., n0:n0 + DFT_BLOCK]
        re = re + torch.matmul(part, basis_cos[n0:n0 + DFT_BLOCK])
        im = im + torch.matmul(part, basis_sin[n0:n0 + DFT_BLOCK])
    mag = torch.sqrt(re * re + im * im + 1e-12)
    if cfg.power == 2.0:
        mag = mag * mag
    return torch.log(torch.clamp(torch.matmul(mag, mel_fb), min=cfg.log_offset))


def pack_bases(basis_cos: torch.Tensor, basis_sin: torch.Tensor,
               mel_fb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's layout of the constants: (cs (n_fft, 2, Fp), per
    sample the cos row then the sin row; mel (Fp, n_mels)), bins
    zero-padded to Fp, a multiple of FREQ_TILE. A frontend packs once and
    passes the result as `packed`."""
    pad = -basis_cos.shape[1] % FREQ_TILE
    return (torch.stack([F.pad(basis_cos, (0, pad)), F.pad(basis_sin, (0, pad))],
                        dim=1).contiguous(),
            F.pad(mel_fb, (0, 0, 0, pad)).contiguous())


def frames_per_thread(batch: int, frames: int, sms: int) -> int:
    """The kernel's frames per thread (a CTA tiles 8× that many frames):
    the largest of 4, 2, 1 whose grid still covers every SM."""
    for fpt in (4, 2):
        if batch * -(-frames // (8 * fpt)) >= sms:
            return fpt
    return 1


_op = None  # torch.ops.yourmt3_tpu_torch.fused_logmel, bound at first use


def fused_logmel(audio: torch.Tensor, basis_cos: torch.Tensor,
                 basis_sin: torch.Tensor, mel_fb: torch.Tensor,
                 cfg: AudioConfig,
                 packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """(B, input_frames) fp32 audio → (B, T, n_mels) fp32 log-mel.

    basis_* are the window-folded DFT bases (n_fft, n_bins), mel_fb
    (n_bins, n_mels); `packed` is their `pack_bases` layout, made here
    when not given. CPU tensors go to the plain version; CUDA tensors
    launch the kernel through its operator, which takes the packed
    layout and checks the arguments (and count one launch), or raise."""
    if audio.is_cpu:
        return fused_logmel_plain(audio, basis_cos, basis_sin, mel_fb, cfg)
    global _op
    if _op is None:
        _op = cuda_build.op("fused_logmel")
    cs, mel = packed if packed is not None else pack_bases(basis_cos, basis_sin, mel_fb)
    sms = torch.cuda.get_device_properties(audio.device).multi_processor_count
    fpt = frames_per_thread(audio.shape[0], cfg.num_frames, sms)
    out = _op(audio, cs, mel, cfg.input_frames, cfg.num_frames, cfg.hop_length,
              float(cfg.log_offset), cfg.power == 2.0, fpt)
    fused_logmel.launches += 1
    return out


fused_logmel.launches = 0  # kernel launches since the last reset
