"""Per-position int8 and int4 KV-cache quantization for decode.

K and V rows are quantized with one fp32 scale per (stream, head,
position) row; decode attention reads half (int8) or a quarter (int4) of
the bytes of a bf16 cache. For a row with max |x| = m the int8 step is
m/127 and the int4 step m/7.

int4 values lie in [-7, 7] and are stored biased by +8, two to a byte.
`quantize_kv4` interleaves them (element 2i in the low nibble of byte i,
2i+1 in the high one); `quantize_kv4_crosspack` splits the row in halves
(element d low, d + dk/2 high) and puts dk before T, the layout of the
int4 cross-attention kernel (ops/int4_cross_attention.py). A zeroed
cache byte decodes to -8, which is harmless: unwritten positions carry
zero scales.

`int8_decode_attention` launches the hand-written kernel
(`csrc/int8_decode_attention.cu`) for CUDA tensors and runs
`int8_decode_attention_plain` for CPU tensors; the int4 attention stays
plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils import profiling
from . import cuda_build

QKV = Tuple[torch.Tensor, torch.Tensor]  # (int8 values, fp32 row scales)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    # a 0-dim tensor divisor: CUDA would multiply by the reciprocal of a
    # Python scalar, which is not the reference's fp32 division
    return torch.full((), x, dtype=torch.float32, device=like.device)


def quantize_kv(x: torch.Tensor) -> QKV:
    """(..., dk) float → ((..., dk) int8, (...,) fp32 scales).

    `torch.round` rounds half to even, as the reference does, so the int8
    bytes equal the reference's on identical inputs."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1) / _f32(127.0, xf)
    safe = torch.clamp(scale, min=1e-30)
    q = torch.round(xf / safe[..., None]).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale[..., None]


def int8_decode_attention_plain(q: torch.Tensor,  # (S, H, M, dk) float
                                k_q: torch.Tensor,  # (S, H, L, dk) int8
                                k_s: torch.Tensor,  # (S, H, L) fp32
                                v_q: torch.Tensor,  # (S, H, L, dk) int8
                                v_s: torch.Tensor,  # (S, H, L) fp32
                                bias: Optional[torch.Tensor]  # (1, H, M, L) or None
                                ) -> torch.Tensor:
    """softmax(q·K^T + bias)·V with int8 K/V, dequantized inside the
    products: logits scale by k_s per column, the V row scales fold into
    the softmax weights.

    Staging as in the reference: q, the int8 values and w·v_s are rounded
    to bf16 (int8 values are exact in bf16) and both products accumulate
    in fp32."""
    f32, bf16 = torch.float32, torch.bfloat16
    logits = torch.matmul(q.to(bf16).to(f32),
                          k_q.to(f32).transpose(-1, -2))  # (S, H, M, L)
    logits = logits * k_s[:, :, None, :]
    if bias is not None:
        logits = logits + bias
    w = torch.softmax(logits, dim=-1)
    w = w * v_s[:, :, None, :]
    out = torch.matmul(w.to(bf16).to(f32), v_q.to(f32))  # (S, H, M, dk)
    return out.to(q.dtype)


_op = None  # torch.ops.yourmt3_tpu_torch.int8_decode_attention, bound at first use


def int8_decode_attention(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                          v_q: torch.Tensor, v_s: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          n: Optional[int] = None, pos=None) -> torch.Tensor:
    """`int8_decode_attention_plain` over the caches' first n rows (n None:
    all L). q (S, H, M, dk): M query rows per KV head (the group under
    grouped heads). bias (1, H, M, n) fp32 or None. pos: None, a host int
    or a 0-dim int64 tensor on the caches' device; with a position, the
    bias must mask the rows past it (the decoder's step bias holds -1e9
    there, whose exp is exactly 0), so they add nothing.

    CPU tensors go to the plain version over rows [0, n). CUDA tensors
    launch the hand-written kernel (`csrc/int8_decode_attention.cu`, the
    operator `torch.ops.yourmt3_tpu_torch.int8_decode_attention`), which
    reads the whole caches in place, rows [0, min(pos + 1, n)) with a
    position, and checks the arguments (and counts one launch), or raise.
    Nothing falls back from one to the other."""
    if pos is not None and bias is None:
        raise ValueError("a position needs the bias that masks the rows past it")
    n = k_q.shape[2] if n is None else n
    if q.is_cpu:
        return int8_decode_attention_plain(q, k_q[:, :, :n], k_s[:, :, :n],
                                           v_q[:, :, :n], v_s[:, :, :n], bias)
    global _op
    if _op is None:
        _op = cuda_build.op("int8_decode_attention")
    if pos is not None and not isinstance(pos, torch.Tensor):
        pos = torch.tensor(int(pos))
    out = _op(q, k_q, k_s, v_q, v_s, bias, n, pos)
    int8_decode_attention.launches += 1
    return out


int8_decode_attention.launches = 0  # kernel launches since the last reset
profiling.register_kernel("int8_decode_attention", int8_decode_attention)


def _quantize_int4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., dk) float → ((..., dk) int32 values in [-7, 7], (...,) fp32)."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1) / _f32(7.0, xf)
    safe = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(xf / safe[..., None]), -7, 7).to(torch.int32)
    return q, scale


def _pack(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return ((lo + 8) | ((hi + 8) << 4)).to(torch.uint8)


def quantize_kv4(x: torch.Tensor) -> QKV:
    """(..., dk) float → ((..., dk//2) uint8 interleaved nibbles, (...,) fp32)."""
    q, scale = _quantize_int4(x)
    return _pack(q[..., 0::2], q[..., 1::2]), scale


def unpack_kv4(p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """packed (..., dk//2) uint8 → (lo, hi) bf16 value planes in [-8, 7]:
    elements 0::2 and 1::2 of the interleaved original."""
    lo = ((p & 0xF).to(torch.int8) - 8).to(torch.bfloat16)
    hi = ((p >> 4).to(torch.int8) - 8).to(torch.bfloat16)
    return lo, hi


def int4_decode_attention(q: torch.Tensor,  # (S, H, 1, dk) float
                          k_p: torch.Tensor,  # (S, H, L, dk//2) uint8
                          k_s: torch.Tensor,  # (S, H, L) fp32
                          v_p: torch.Tensor,  # (S, H, L, dk//2) uint8
                          v_s: torch.Tensor,  # (S, H, L) fp32
                          bias: Optional[torch.Tensor]  # (1, H, 1, L) or None
                          ) -> torch.Tensor:
    """softmax(q·K^T + bias)·V over interleaved int4 K/V, as two
    half-width products per side: q·k = q[0::2]·k_lo + q[1::2]·k_hi, and
    the output's even and odd elements come from the V planes.

    Staging as in the reference: q and w·v_s are rounded to bf16 (int4
    values are exact in bf16) and every product accumulates in fp32."""
    f32, bf16 = torch.float32, torch.bfloat16
    k_lo, k_hi = unpack_kv4(k_p)
    qb = q.to(bf16).to(f32)
    logits = (torch.matmul(qb[..., 0::2], k_lo.to(f32).transpose(-1, -2))
              + torch.matmul(qb[..., 1::2], k_hi.to(f32).transpose(-1, -2)))
    logits = logits * k_s[:, :, None, :]
    if bias is not None:
        logits = logits + bias
    w = torch.softmax(logits, dim=-1)
    w = (w * v_s[:, :, None, :]).to(bf16).to(f32)
    v_lo, v_hi = unpack_kv4(v_p)
    out_lo = torch.matmul(w, v_lo.to(f32))
    out_hi = torch.matmul(w, v_hi.to(f32))
    out = torch.stack([out_lo, out_hi], dim=-1)
    return out.reshape(*out_lo.shape[:-1], out_lo.shape[-1] * 2).to(q.dtype)


def quantize_kv4_crosspack(x: torch.Tensor) -> QKV:
    """(S, H, T, dk) float → ((S, H, dk//2, T) uint8, (S, H, T) fp32).

    Split-half packing for the int4 cross-attention kernel: byte (d, t)
    holds element d in its low nibble and element d + dk/2 in its high
    nibble, dk-major. Scales as in quantize_kv4."""
    q, scale = _quantize_int4(x)
    dk2 = q.shape[-1] // 2
    packed = _pack(q[..., :dk2], q[..., dk2:])  # (S, H, T, dk2)
    return packed.transpose(-1, -2).contiguous(), scale


def dequantize_kv4_crosspack(packed: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    """Inverse of quantize_kv4_crosspack: → (S, H, T, dk) fp32."""
    p = packed.transpose(-1, -2).to(torch.int32)  # (S, H, T, dk2)
    vals = torch.cat([(p & 15) - 8, (p >> 4) - 8], dim=-1).to(torch.float32)
    return vals * scale[..., None]
