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
(`csrc/int4_cross_attention.cu`) for CUDA tensors and runs
`int4_cross_attention_plain` for CPU tensors; it never falls back from
one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from .decode_attention import _as_3d, _check

_KERNEL = "int4_cross_attention"
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_DKS = (16, 32, 64, 128)
MAX_T = 4096  # the logits row lives in shared memory


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


def _library() -> ctypes.CDLL:
    from .cuda_build import load
    lib = load(_KERNEL)
    fn = lib.int4_cross_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def int4_cross_attention(
    q: torch.Tensor,  # (S, H, dk) or (S, H, 1, dk), fp32 or bf16
    k4: torch.Tensor,  # (S, H, dk/2, T) uint8
    ks: torch.Tensor,  # (S, H, T) fp32
    v4: torch.Tensor,
    vs: torch.Tensor,
) -> torch.Tensor:
    """→ attention output with q's shape and dtype.

    CPU tensors go to the plain version; CUDA tensors launch the kernel
    (and count one launch) or raise."""
    if q.device.type == "cpu":
        return int4_cross_attention_plain(q, k4, ks, v4, vs)
    if q.device.type != "cuda":
        raise ValueError(f"int4_cross_attention runs on cuda or cpu, not "
                         f"{q.device}")
    q3, squeeze = _as_3d(q)
    S, H, dk = q3.shape
    if dk not in _DKS:
        raise ValueError(f"dk={dk} not in {_DKS}")
    if k4.ndim != 4:
        raise ValueError(f"k4 must be (S, H, dk/2, T), got {tuple(k4.shape)}")
    T = k4.shape[3]
    if not 1 <= T <= MAX_T:
        raise ValueError(f"T={T} outside [1, {MAX_T}]")
    dev = q.device
    _check(q3, "q", dev, tuple(_Q_CODES))
    for t, name in ((k4, "k4"), (v4, "v4")):
        _check(t, name, dev, torch.uint8, (S, H, dk // 2, T))
        if T % 16 == 0 and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for t, name in ((ks, "ks"), (vs, "vs")):
        _check(t, name, dev, torch.float32, (S, H, T))

    out = torch.empty((S, H, dk), dtype=q.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().int4_cross_attention_launch(
        q3.data_ptr(), k4.data_ptr(), ks.data_ptr(), v4.data_ptr(),
        vs.data_ptr(), out.data_ptr(), S, H, dk, T, _Q_CODES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"int4_cross_attention launch failed: CUDA error "
                           f"{err}")
    int4_cross_attention.launches += 1
    return out[:, :, None, :] if squeeze else out


int4_cross_attention.launches = 0  # kernel launches since the last reset
