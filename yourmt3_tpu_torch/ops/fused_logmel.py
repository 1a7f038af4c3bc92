"""Fused log-mel frontend: the CUDA kernel's wrapper, its plain PyTorch
version, and the kernel's FFT algorithm in plain PyTorch.

    frames (B, T, n_fft) from the reflect-padded audio row
    re, im = frames @ basis_cos, frames @ basis_sin   (window folded in)
    mag    = sqrt(re² + im² + 1e-12)                  (squared if power == 2)
    out    = log(max(mag @ mel_fb, log_offset))       → (B, T, n_mels)

`fused_logmel` launches the hand-written kernel (`csrc/fused_logmel.cu`,
bound as the PyTorch operator `torch.ops.yourmt3_tpu_torch.fused_logmel`)
for CUDA tensors and runs `fused_logmel_plain` for CPU tensors; it never
falls back from one to the other. The kernel computes the same function
as a real FFT in shared memory (two frames packed as the real and
imaginary parts of one complex n_fft-point Stockham FFT, then split) and a
band-sparse mel product; `pack_bases` turns the window-folded DFT bases
and the filterbank into its constants (the window, the twiddle table and
the mel bands), and `fused_logmel_fft_plain` repeats its algorithm in
plain PyTorch for the tests. The reflect padding stays a torch op inside
the operator, as the reference leaves it to XLA.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config.audio import AudioConfig
from ..utils import profiling
from . import cuda_build

DFT_BLOCK = 32  # samples per partial DFT sum of the plain version
MIN_NFFT, MAX_NFFT = 256, 4096  # the kernel's FFT sizes: powers of two
RADIX = 8  # every Stockham pass after the first
SQRT_HALF = 0.70710678118654752  # the only constant inside the butterflies
# the largest the check of pack_bases lets a basis entry differ from the
# window-folded DFT: a few fp32 roundings of values in [-1, 1]
BASIS_TOL = 1e-6

Packed = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def reflect_pad(audio: torch.Tensor, n_fft: int) -> torch.Tensor:
    """(B, L) → (B, L + n_fft): center padding by n_fft/2 on each side."""
    pad = n_fft // 2
    return F.pad(audio[:, None], (pad, pad), mode="reflect")[:, 0]


def _frames(audio: torch.Tensor, cfg: AudioConfig, count: int) -> torch.Tensor:
    """(B, count, n_fft) view of the padded row; samples past it read 0."""
    n_fft, hop = cfg.n_fft, cfg.hop_length
    x = reflect_pad(audio.to(torch.float32), n_fft)
    need = (count - 1) * hop + n_fft
    if x.shape[1] < need:
        x = F.pad(x, (0, need - x.shape[1]))
    return x.unfold(1, n_fft, hop)[:, :count]


def fused_logmel_plain(audio: torch.Tensor, basis_cos: torch.Tensor,
                       basis_sin: torch.Tensor, mel_fb: torch.Tensor,
                       cfg: AudioConfig) -> torch.Tensor:
    """The function in plain PyTorch, as the TPU kernel computes it: fp32
    products, and the DFT sums taken in two levels, one matrix product
    per DFT_BLOCK samples added to the totals. (One fp32 product over all
    n_fft samples drifts by up to ~1e-3 in log-mel next to a loud tone.)"""
    frames = _frames(audio, cfg, cfg.num_frames)  # (B, T, n_fft) view
    re = im = 0.0
    for n0 in range(0, cfg.n_fft, DFT_BLOCK):
        part = frames[..., n0:n0 + DFT_BLOCK]
        re = re + torch.matmul(part, basis_cos[n0:n0 + DFT_BLOCK])
        im = im + torch.matmul(part, basis_sin[n0:n0 + DFT_BLOCK])
    mag = torch.sqrt(re * re + im * im + 1e-12)
    if cfg.power == 2.0:
        mag = mag * mag
    return torch.log(torch.clamp(torch.matmul(mag, mel_fb), min=cfg.log_offset))


# ---------------------------------------------------------------------------
# The kernel's constants and algorithm
# ---------------------------------------------------------------------------

def check_n_fft(n_fft: int) -> None:
    if n_fft < MIN_NFFT or n_fft > MAX_NFFT or n_fft & (n_fft - 1):
        raise ValueError(f"n_fft={n_fft}: the kernel takes a power of two "
                         f"from {MIN_NFFT} to {MAX_NFFT}")


def fft_passes(n_fft: int):
    """[(radix, Ns)] of the Stockham schedule: one pass of radix 2, 4 or 8
    (whatever is left of log2 n_fft over 3), then radix-8 passes; Ns is the
    product of the radices before the pass."""
    first = 1 << (int(math.log2(n_fft)) % 3 or 3)
    passes, ns = [(first, 1)], first
    while ns < n_fft:
        passes.append((RADIX, ns))
        ns *= RADIX
    return passes


def twiddle_table(n_fft: int) -> np.ndarray:
    """(n_fft - first radix, 2) fp32 (re, im) twiddles of the radix-8
    passes, computed in float64: for the pass of Ns, entry (Ns - first)
    + (r - 1)·Ns + q holds exp(-2πi·r·q / (8·Ns)), r = 1..7, q < Ns."""
    rows = []
    for radix, ns in fft_passes(n_fft)[1:]:
        r = np.arange(1, radix)[:, None]
        q = np.arange(ns)[None, :]
        ang = 2.0 * np.pi * (r * q) / (radix * ns)
        rows.append(np.stack([np.cos(ang), -np.sin(ang)], -1).reshape(-1, 2))
    return np.concatenate(rows).astype(np.float32)


def mel_bands(mel_fb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bands (M, 3) int32: per mel column its first nonzero bin, one past
    its last, and the offset of its weights; weights (nnz,) fp32: each
    column's rows lo..hi-1, zeros inside the band kept). A column with no
    nonzero bin gets an empty band."""
    fb = mel_fb.detach().to("cpu", torch.float32)
    n_bins = fb.shape[0]
    nz = fb != 0
    has = nz.any(0)
    lo = torch.where(has, nz.int().argmax(0), 0)
    hi = torch.where(has, n_bins - nz.flip(0).int().argmax(0), 0)
    width = hi - lo
    off = torch.cumsum(width, 0) - width
    weights = torch.cat([fb[a:b, m] for m, (a, b) in
                         enumerate(zip(lo.tolist(), hi.tolist()))])
    bands = torch.stack([lo, hi, off], 1).to(torch.int32)
    return bands.to(mel_fb.device), weights.to(mel_fb.device)


def pack_bases(basis_cos: torch.Tensor, basis_sin: torch.Tensor,
               mel_fb: torch.Tensor) -> Packed:
    """The kernel's constants: (window (n_fft,), twiddles (n_fft - first
    radix, 2), mel bands (M, 3) int32, mel weights (nnz,)), on the bases'
    device. The window is the bases' zero-frequency column; the bases must
    be the window-folded DFT of it within fp32 rounding, or this raises
    ValueError. A frontend packs once and passes the result as `packed`."""
    n_fft, n_bins = basis_cos.shape
    check_n_fft(n_fft)
    if (basis_sin.shape != basis_cos.shape or n_bins != n_fft // 2 + 1
            or mel_fb.ndim != 2 or mel_fb.shape[0] != n_bins):
        raise ValueError(
            f"bases {tuple(basis_cos.shape)}, {tuple(basis_sin.shape)} and "
            f"mel_fb {tuple(mel_fb.shape)}: expected ({n_fft}, {n_fft // 2 + 1}) "
            f"each and ({n_fft // 2 + 1}, n_mels)")
    window = basis_cos[:, 0].to(torch.float32).contiguous()
    dev = basis_cos.device
    t = torch.arange(n_fft, device=dev, dtype=torch.int64)
    f = torch.arange(n_bins, device=dev, dtype=torch.int64)
    ang = (t[:, None] * f[None, :] % n_fft).double() * (2.0 * math.pi / n_fft)
    w = window.double()[:, None]
    err = max((basis_cos.double() - torch.cos(ang) * w).abs().max().item(),
              (basis_sin.double() + torch.sin(ang) * w).abs().max().item())
    if not err <= BASIS_TOL:
        raise ValueError(f"the bases are not the window-folded DFT of their "
                         f"zero-frequency column (max |diff| {err:.3g} > "
                         f"{BASIS_TOL}): the FFT kernel computes only that")
    twiddles = torch.from_numpy(twiddle_table(n_fft)).to(dev)
    return (window, twiddles, *mel_bands(mel_fb))


def _dft(v: torch.Tensor, radix: int) -> torch.Tensor:
    """The kernel's in-register DFT of size radix (2, 4, 8) along dim -2,
    natural order out: radix-2 decimation-in-frequency stages whose
    twiddles are the powers of exp(-2πi/8), -i and (±1 - i)·√½."""
    x = list(v.unbind(-2))
    w8 = [1.0, complex(SQRT_HALF, -SQRT_HALF), -1j,
          complex(-SQRT_HALF, -SQRT_HALF)]
    half = radix // 2
    while half:
        for s in range(0, radix, 2 * half):
            for i in range(half):
                a, b = x[s + i], x[s + i + half]
                tw = w8[i * (4 // half)] if half > 1 else 1.0
                x[s + i] = a + b
                x[s + i + half] = a - b if tw == 1.0 else (a - b) * tw
        half //= 2
    bits = radix.bit_length() - 1
    rev = [int(f"{k:0{bits}b}"[::-1], 2) for k in range(radix)]
    return torch.stack([x[rev[k]] for k in range(radix)], -2)


def stockham_fft(z: torch.Tensor, twiddles: torch.Tensor) -> torch.Tensor:
    """(..., N) complex64 → its DFT in natural order, by the kernel's
    Stockham passes: pass (R, Ns) reads v[r, j] = z[j + r·N/R], multiplies
    by the table's exp(-2πi·r·(j mod Ns)/(R·Ns)), takes the R-point DFT
    and writes V[r, j] to (j div Ns)·Ns·R + (j mod Ns) + r·Ns."""
    lead, n = z.shape[:-1], z.shape[-1]
    tw = torch.complex(twiddles[:, 0], twiddles[:, 1])
    first = fft_passes(n)[0][0]
    for radix, ns in fft_passes(n):
        v = z.reshape(*lead, radix, n // radix)
        if ns > 1:
            q = torch.arange(n // radix, device=z.device) % ns
            rows = (ns - first) + (torch.arange(1, radix, device=z.device)[:, None]
                                   - 1) * ns + q[None, :]
            v = torch.cat([v[..., :1, :], v[..., 1:, :] * tw[rows]], -2)
        v = _dft(v, radix)
        g = n // (radix * ns)
        z = v.reshape(*lead, radix, g, ns).transpose(-3, -2).reshape(*lead, n)
    return z


def fused_logmel_fft_plain(audio: torch.Tensor, basis_cos: torch.Tensor,
                           basis_sin: torch.Tensor, mel_fb: torch.Tensor,
                           cfg: AudioConfig,
                           packed: Optional[Packed] = None) -> torch.Tensor:
    """The kernel's algorithm in plain PyTorch (fp32), for the tests:
    frames 2p and 2p+1 windowed into the real and imaginary parts of one
    complex n_fft-point Stockham FFT with the kernel's twiddle table (a
    frame past T reads the padded row, zeros past its end), split into
    the two frames' spectra, the magnitude, then each mel column summed
    over its band alone. Nothing on the main path calls it."""
    window, twiddles, bands, weights = (
        packed if packed is not None else pack_bases(basis_cos, basis_sin, mel_fb))
    T, n_fft = cfg.num_frames, cfg.n_fft
    pairs = -(-T // 2)
    frames = _frames(audio, cfg, 2 * pairs) * window  # (B, 2·pairs, n_fft)
    z = stockham_fft(torch.complex(frames[:, 0::2], frames[:, 1::2]), twiddles)
    n_bins = n_fft // 2 + 1
    a = z[..., :n_bins]
    b = z[..., (n_fft - torch.arange(n_bins, device=z.device)) % n_fft]
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    # X_even = (Z[k] + conj Z[N-k]) / 2, X_odd = (Z[k] - conj Z[N-k]) / 2i
    sq = torch.stack([((ar + br) * 0.5) ** 2 + ((ai - bi) * 0.5) ** 2,
                      ((ai + bi) * 0.5) ** 2 + ((ar - br) * 0.5) ** 2], 2)
    mag = torch.sqrt(sq + 1e-12).reshape(audio.shape[0], 2 * pairs, n_bins)[:, :T]
    if cfg.power == 2.0:
        mag = mag * mag
    lo, hi, off = bands.long().unbind(1)
    width = int((hi - lo).max().item()) if len(lo) else 0
    k = torch.arange(max(width, 1), device=mag.device)
    inside = k[None, :] < (hi - lo)[:, None]  # (M, W)
    bins = torch.where(inside, lo[:, None] + k[None, :], 0)
    wts = torch.where(inside, weights[torch.where(inside, off[:, None] + k, 0)],
                      torch.zeros((), dtype=weights.dtype, device=weights.device))
    mel = (mag[..., bins] * wts).sum(-1)
    return torch.log(torch.clamp(mel, min=cfg.log_offset))


def fused_logmel_float64(audio: torch.Tensor, basis_cos: torch.Tensor,
                         mel_fb: torch.Tensor, cfg: AudioConfig) -> torch.Tensor:
    """The function in float64 (torch.fft on the bases' window and the
    filterbank as given): the yardstick for the fp32 routes' rounding,
    which a mel bin in a deep spectral null turns into log-mel errors of
    ~1e-3. Nothing on the main path calls it."""
    frames = _frames(audio, cfg, cfg.num_frames).double()
    spec = torch.fft.rfft(frames * basis_cos[:, 0].double(), dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-12)
    if cfg.power == 2.0:
        mag = mag * mag
    return torch.log(torch.clamp(torch.matmul(mag, mel_fb.double()),
                                 min=cfg.log_offset))


def frames_per_cta(batch: int, frames: int, sms: int) -> int:
    """The kernel's frames per CTA (an even tile of the segment's frames):
    the largest of 16, 8, 4, 2 whose grid still gives every SM a CTA (on
    an H100 SXM the fastest tile at B = 16 and 8, PERF.md)."""
    for tile in (16, 8, 4):
        if batch * -(-frames // tile) >= sms:
            return tile
    return 2


_op = None  # torch.ops.yourmt3_tpu_torch.fused_logmel, bound at first use


def fused_logmel(audio: torch.Tensor, basis_cos: torch.Tensor,
                 basis_sin: torch.Tensor, mel_fb: torch.Tensor,
                 cfg: AudioConfig, packed: Optional[Packed] = None
                 ) -> torch.Tensor:
    """(B, input_frames) fp32 audio → (B, T, n_mels) fp32 log-mel.

    basis_* are the window-folded DFT bases (n_fft, n_bins), mel_fb
    (n_bins, n_mels); `packed` is their `pack_bases` layout, made here
    when not given. CPU tensors go to the plain version; CUDA tensors
    launch the kernel through its operator, which checks the arguments
    (and count one launch), or raise."""
    if audio.is_cpu:
        return fused_logmel_plain(audio, basis_cos, basis_sin, mel_fb, cfg)
    global _op
    if _op is None:
        _op = cuda_build.op("fused_logmel")
    if packed is None:
        packed = pack_bases(basis_cos, basis_sin, mel_fb)
    sms = torch.cuda.get_device_properties(audio.device).multi_processor_count
    out = _op(audio, *packed, cfg.input_frames, cfg.num_frames, cfg.hop_length,
              float(cfg.log_offset), cfg.power == 2.0,
              frames_per_cta(audio.shape[0], cfg.num_frames, sms))
    fused_logmel.launches += 1
    return out


fused_logmel.launches = 0  # kernel launches since the last reset
profiling.register_kernel("fused_logmel", fused_logmel)
