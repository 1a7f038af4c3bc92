"""Cross-attention decode step over split-half packed int4 K/V: the CUDA
kernel's wrapper and its plain PyTorch version.

Layouts are those of `kv_quant.quantize_kv4_crosspack`: `k4`, `v4`
(S, H, dk/2, T) uint8, byte (d, t) holding element d in its low nibble and
element d + dk/2 in its high one, both biased by +8; `ks`, `vs` (S, H, T)
fp32 row scales. With nib = stored nibble (value + 8), the algebra is

    logits_t = ks_t · (Σ_d q_d · nib_{d,t} − 8 Σ_d q_d)
    p = exp(logits − max), w = p · vs
    out_d = (Σ_t w_t · nib_{d,t} − 8 Σ_t w_t) / max(Σ_t p_t, 1e-30)

`int4_cross_attention` launches the hand-written kernel
(`csrc/int4_cross_attention.cu`, bound as the PyTorch operator
`torch.ops.yourmt3_tpu_torch.int4_cross_attention`) for CUDA tensors and
runs `int4_cross_attention_plain` for CPU tensors; it never falls back
from one to the other.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import cuda_build
from .decode_attention import _as_3d


def int4_cross_attention_plain(q: torch.Tensor, k4: torch.Tensor,
                               ks: torch.Tensor, v4: torch.Tensor,
                               vs: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 throughout)."""
    q3, squeeze = _as_3d(q)
    f32 = torch.float32
    qf = q3.to(f32)
    dk2 = qf.shape[-1] // 2

    def nibbles(p):  # (S, H, dk2, T) uint8 → (lo, hi) fp32 in [1, 15]
        b = p.to(torch.int32)
        return (b & 15).to(f32), (b >> 4).to(f32)

    k_lo, k_hi = nibbles(k4)
    raw = (torch.einsum("shd,shdt->sht", qf[..., :dk2], k_lo)
           + torch.einsum("shd,shdt->sht", qf[..., dk2:], k_hi))
    logits = (raw - 8.0 * qf.sum(-1, keepdim=True)) * ks
    p = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    denom = p.sum(-1, keepdim=True)
    w = p * vs
    wsum = w.sum(-1, keepdim=True)
    v_lo, v_hi = nibbles(v4)
    out = torch.cat([torch.einsum("sht,shdt->shd", w, v_lo) - 8.0 * wsum,
                     torch.einsum("sht,shdt->shd", w, v_hi) - 8.0 * wsum], -1)
    out = (out / torch.clamp(denom, min=1e-30)).to(q.dtype)
    return out[:, :, None, :] if squeeze else out


_op = None  # torch.ops.yourmt3_tpu_torch.int4_cross_attention, bound at first use


def int4_cross_attention(
    q: torch.Tensor,  # (S, H, dk) or (S, H, 1, dk), fp32 or bf16
    k4: torch.Tensor,  # (S, H, dk/2, T) uint8
    ks: torch.Tensor,  # (S, H, T) fp32
    v4: torch.Tensor,
    vs: torch.Tensor,
) -> torch.Tensor:
    """→ attention output with q's shape and dtype.

    CPU tensors go to the plain version; CUDA tensors launch the kernel
    through its operator, which checks the arguments (and count one
    launch), or raise."""
    if q.is_cpu:
        return int4_cross_attention_plain(q, k4, ks, v4, vs)
    global _op
    if _op is None:
        _op = cuda_build.op("int4_cross_attention")
    out = _op(q, k4, ks, v4, vs)
    int4_cross_attention.launches += 1
    return out


int4_cross_attention.launches = 0  # kernel launches since the last reset
profiling.register("kernel.int4_cross_attention.launches",
                   lambda f=int4_cross_attention: f.launches)
