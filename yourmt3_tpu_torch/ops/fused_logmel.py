"""Fused log-mel frontend: the CUDA kernel's wrapper and its plain
PyTorch version.

    frames (B, T, n_fft) from the reflect-padded audio row
    re, im = frames @ basis_cos, frames @ basis_sin   (window folded in)
    mag    = sqrt(re² + im² + 1e-12)                  (squared if power == 2)
    out    = log(max(mag @ mel_fb, log_offset))       → (B, T, n_mels)

`fused_logmel` launches the hand-written kernel (`csrc/fused_logmel.cu`)
for CUDA tensors, which keeps the frames and the spectra on chip, and
runs `fused_logmel_plain` for CPU tensors; it never falls back from one
to the other. The reflect padding stays a torch op, as the reference
leaves it to XLA.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..config.audio import AudioConfig
from .decode_attention import _check

_KERNEL = "fused_logmel"
FREQ_TILE = 128  # bins per kernel frequency tile
DFT_BLOCK = 32  # samples per partial DFT sum (KB in the kernel)
MAX_MELS = 512


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


def _library() -> ctypes.CDLL:
    from .cuda_build import load
    lib = load(_KERNEL)
    fn = lib.fused_logmel_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, ctypes.c_float, i, i, p]
        fn.restype = ctypes.c_int
    return lib


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


def fused_logmel(audio: torch.Tensor, basis_cos: torch.Tensor,
                 basis_sin: torch.Tensor, mel_fb: torch.Tensor,
                 cfg: AudioConfig,
                 packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                 ) -> torch.Tensor:
    """(B, input_frames) fp32 audio → (B, T, n_mels) fp32 log-mel.

    basis_* are the window-folded DFT bases (n_fft, n_bins), mel_fb
    (n_bins, n_mels); `packed` is their `pack_bases` layout, made here
    when not given. CPU tensors go to the plain version; CUDA tensors
    launch the kernel (and count one launch) or raise."""
    if audio.device.type == "cpu":
        return fused_logmel_plain(audio, basis_cos, basis_sin, mel_fb, cfg)
    if audio.device.type != "cuda":
        raise ValueError(f"fused_logmel runs on cuda or cpu, not {audio.device}")
    if audio.ndim != 2 or audio.shape[1] != cfg.input_frames:
        raise ValueError(f"audio must be (B, {cfg.input_frames}), got "
                         f"{tuple(audio.shape)}")
    n_fft, n_bins = cfg.n_fft, cfg.n_fft // 2 + 1
    n_mels = mel_fb.shape[1]
    if n_fft % DFT_BLOCK:
        raise ValueError(f"n_fft={n_fft}: the kernel takes a multiple of "
                         f"{DFT_BLOCK}")
    if n_mels % 32 or not 32 <= n_mels <= MAX_MELS:
        raise ValueError(f"n_mels={n_mels}: the kernel takes a multiple of 32 "
                         f"up to {MAX_MELS}")
    dev = audio.device
    _check(audio, "audio", dev, torch.float32)
    for t, name, shape in ((basis_cos, "basis_cos", (n_fft, n_bins)),
                           (basis_sin, "basis_sin", (n_fft, n_bins)),
                           (mel_fb, "mel_fb", (n_bins, n_mels))):
        _check(t, name, dev, torch.float32, shape)
    cs, mel = packed or pack_bases(basis_cos, basis_sin, mel_fb)
    fp = n_bins - n_bins % -FREQ_TILE
    _check(cs, "packed cos/sin", dev, torch.float32, (n_fft, 2, fp))
    _check(mel, "packed mel", dev, torch.float32, (fp, n_mels))
    padded = reflect_pad(audio, n_fft).contiguous()
    B, T = audio.shape[0], cfg.num_frames
    out = torch.empty((B, T, n_mels), dtype=torch.float32, device=dev)
    fpt = frames_per_thread(B, T, torch.cuda.get_device_properties(dev)
                            .multi_processor_count)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().fused_logmel_launch(
        padded.data_ptr(), cs.data_ptr(), mel.data_ptr(), out.data_ptr(), B,
        padded.shape[1], T, n_fft, cfg.hop_length, mel.shape[0], n_mels,
        float(cfg.log_offset), int(cfg.power == 2.0), fpt, stream)
    if err != 0:
        raise RuntimeError(f"fused_logmel launch failed: CUDA error {err}")
    fused_logmel.launches += 1
    return out


fused_logmel.launches = 0  # kernel launches since the last reset
