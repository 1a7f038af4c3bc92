"""Paged single-query decode attention: the CUDA kernel's wrapper, its
plain PyTorch version, and the paged-cache helpers.

Caches are paged (NB, S, H, block, dk), position-major within a page, so
one decode step writes one (dk,) row per (stream, head). int8 caches keep
fp32 row scales stream-major, (S, NB, H, block), so every cache tensor
keeps its stream axis where the beam reorder expects it (axis 1 for 5-D,
axis 0 otherwise).

`paged_decode_attention` launches the hand-written split-KV kernel
(`csrc/paged_decode_attention.cu`, bound as the PyTorch operator
`torch.ops.yourmt3_tpu_torch.paged_decode_attention`) for CUDA tensors and
runs `paged_decode_attention_plain` for CPU tensors; it never falls back
from one to the other. `paged_decode_attention_split_plain` repeats the
kernel's split-and-merge algebra in plain PyTorch for the tests.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.layers import distance_buckets, relative_position_bucket
from ..utils import profiling
from . import cuda_build

NEG_INF = -1e30


def _as_3d(q: torch.Tensor):
    if q.ndim == 4:
        if q.shape[2] != 1:
            raise ValueError(f"q must be (S, H, 1, dk), got {tuple(q.shape)}")
        return q[:, :, 0, :], True
    if q.ndim != 3:
        raise ValueError(f"q must be (S, H, dk) or (S, H, 1, dk), got "
                         f"{tuple(q.shape)}")
    return q, False


def paged_decode_attention_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
    bias_row: Optional[torch.Tensor] = None,
    rel_table: Optional[torch.Tensor] = None, rel_max_distance: int = 128,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch (fp32 throughout)."""
    q3, squeeze = _as_3d(q)
    S, H, dk = q3.shape
    NB, _, _, block, _ = k_cache.shape
    L = NB * block
    f32 = torch.float32

    def dense(c):  # (NB, S, H, block, dk) → (S, H, L, dk)
        return c.permute(1, 2, 0, 3, 4).reshape(S, H, L, dk).to(f32)

    def rows(sc):  # (S, NB, H, block) → (S, H, L)
        return sc.permute(0, 2, 1, 3).reshape(S, H, L)

    logits = torch.einsum("shd,shld->shl", q3.to(f32), dense(k_cache))
    if k_scale is not None:
        logits = logits * rows(k_scale)
    j = torch.arange(L, device=q.device, dtype=torch.int32)
    if rel_table is not None:
        bucket = relative_position_bucket(j - pos, False, rel_table.shape[0],
                                          rel_max_distance)
        logits = logits + rel_table.to(f32)[bucket.long()].T[None]
    elif bias_row is not None:
        logits = logits + bias_row.to(f32)[None]
    logits = torch.where(j <= pos, logits, torch.full_like(logits, NEG_INF))
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    denom = torch.sum(p, dim=-1, keepdim=True)
    if v_scale is not None:
        p = p * rows(v_scale)
    out = torch.einsum("shl,shld->shd", p, dense(v_cache))
    out = (out / torch.clamp(denom, min=1e-30)).to(q.dtype)
    return out[:, :, None, :] if squeeze else out


def paged_decode_attention_split_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int,
    split_rows: int, bias_row: Optional[torch.Tensor] = None,
    rel_table: Optional[torch.Tensor] = None, rel_max_distance: int = 128,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's split-KV algebra in plain PyTorch (fp32), for the tests.

    The cache's rows [0, L) are cut into ranges of `split_rows`. The
    kernel cuts only the live rows [0, pos]; cutting the whole cache also
    covers ranges wholly past pos, as a position held on the device would
    give. Each range keeps the partial softmax state of
    its live rows (j <= pos): max m_i, normaliser l_i = Σ exp(x - m_i) and
    unnormalised accumulator acc_i = Σ exp(x - m_i) · v_scale · V; a range
    wholly past pos keeps m_i = NEG_INF, l_i = 0, acc_i = 0. The merge
    weighs each by e_i = exp(m_i - max m) and returns Σ e_i acc_i /
    max(Σ e_i l_i, 1e-30) in q's dtype."""
    q3, squeeze = _as_3d(q)
    S, H, dk = q3.shape
    NB, _, _, block, _ = k_cache.shape
    L = NB * block
    f32 = torch.float32
    k = k_cache.permute(1, 2, 0, 3, 4).reshape(S, H, L, dk).to(f32)
    v = v_cache.permute(1, 2, 0, 3, 4).reshape(S, H, L, dk).to(f32)
    logits = torch.einsum("shd,shld->shl", q3.to(f32), k)
    if k_scale is not None:
        logits = logits * k_scale.permute(0, 2, 1, 3).reshape(S, H, L)
    j = torch.arange(L, device=q.device, dtype=torch.int32)
    if rel_table is not None:
        bucket = relative_position_bucket(j - pos, False, rel_table.shape[0],
                                          rel_max_distance)
        logits = logits + rel_table.to(f32)[bucket.long()].T[None]
    elif bias_row is not None:
        logits = logits + bias_row.to(f32)[None]
    live = j <= pos
    logits = torch.where(live, logits, torch.full_like(logits, NEG_INF))
    vsc = (v_scale.permute(0, 2, 1, 3).reshape(S, H, L) if v_scale is not None
           else torch.ones_like(logits))
    parts = []
    for r0 in range(0, L, split_rows):
        r = slice(r0, min(r0 + split_rows, L))
        m = torch.amax(logits[..., r], dim=-1, keepdim=True)
        p = torch.where(live[r], torch.exp(logits[..., r] - m), torch.zeros_like(m))
        acc = torch.einsum("shl,shld->shd", p * vsc[..., r], v[..., r, :])
        parts.append((m, p.sum(-1, keepdim=True), acc))
    mm = torch.amax(torch.cat([m for m, _, _ in parts], -1), dim=-1, keepdim=True)
    ll = sum(l * torch.exp(m - mm) for m, l, _ in parts)
    acc = sum(a * torch.exp(m - mm) for m, _, a in parts)
    out = (acc / torch.clamp(ll, min=1e-30)).to(q.dtype)
    return out[:, :, None, :] if squeeze else out


_op = None  # torch.ops.yourmt3_tpu_torch.paged_decode_attention, bound at first use


def paged_decode_attention(
    q: torch.Tensor,  # (S, H, dk) or (S, H, 1, dk)
    k_cache: torch.Tensor,  # (NB, S, H, block, dk)
    v_cache: torch.Tensor,
    pos: int,  # lockstep decode position
    bias_row: Optional[torch.Tensor] = None,  # (H, L) fp32
    rel_table: Optional[torch.Tensor] = None,  # (buckets, H) fp32
    rel_max_distance: int = 128,
    k_scale: Optional[torch.Tensor] = None,  # (S, NB, H, block) fp32
    v_scale: Optional[torch.Tensor] = None,
    dist_buckets: Optional[torch.Tensor] = None,  # see distance_buckets()
) -> torch.Tensor:
    """→ attention output with q's shape and dtype.

    Bias options (mutually exclusive): `bias_row`, an explicit additive
    (H, L) row, or `rel_table`, the T5 decoder bucket table from which
    the kernel builds the bias (gathering `dist_buckets`, built here from
    `rel_max_distance` when not given). Neither: no bias
    (cross-attention). int8 pages need both scale tensors.

    CPU tensors go to the plain version; CUDA tensors launch the kernel
    through its operator, which checks the arguments (and count one
    launch), or raise."""
    if q.is_cpu:
        if bias_row is not None and rel_table is not None:
            raise ValueError("bias_row and rel_table are mutually exclusive")
        if (k_scale is None) != (v_scale is None):
            raise ValueError("k_scale and v_scale come together")
        return paged_decode_attention_plain(
            q, k_cache, v_cache, pos, bias_row=bias_row, rel_table=rel_table,
            rel_max_distance=rel_max_distance, k_scale=k_scale,
            v_scale=v_scale)
    global _op
    if _op is None:
        _op = cuda_build.op("paged_decode_attention")
    if rel_table is not None and dist_buckets is None:
        dist_buckets = distance_buckets(rel_table.shape[0], rel_max_distance,
                                        q.device)
    out = _op(q, k_cache, v_cache, int(pos), bias_row, rel_table, dist_buckets,
              k_scale, v_scale)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0  # kernel launches since the last reset
profiling.register_kernel("paged_decode_attention", paged_decode_attention)


def decode_splits(pos: int):
    """(ranges, rows per range) that the kernel picks at decode position
    `pos`: ranges of 128 rows, chosen from the cache length alone, so a
    stream's output does not depend on the batch it is decoded in."""
    return tuple(cuda_build.op("paged_decode_splits")(pos))


# ---------------------------------------------------------------------------
# Paged-cache helpers
# ---------------------------------------------------------------------------

def empty_paged_cache(streams: int, heads: int, dk: int, max_len: int,
                      block: int = 128, dtype=torch.bfloat16,
                      device=None) -> torch.Tensor:
    if max_len % block:
        raise ValueError(f"max_len {max_len} is not a multiple of {block}")
    return torch.zeros((max_len // block, streams, heads, block, dk),
                       dtype=dtype, device=device)


def empty_paged_scales(streams: int, heads: int, max_len: int,
                       block: int = 128, device=None) -> torch.Tensor:
    """fp32 row-scale pages for int8 caches, stream-major."""
    if max_len % block:
        raise ValueError(f"max_len {max_len} is not a multiple of {block}")
    return torch.zeros((streams, max_len // block, heads, block),
                       dtype=torch.float32, device=device)


def dense_to_paged(kv: torch.Tensor, block: int = 128) -> torch.Tensor:
    """(S, H, T, dk) dense KV → (NB, S, H, block, dk) pages, zero-padding T
    up to a multiple of `block` (the caller masks the padding with
    pos = T - 1)."""
    S, H, T, dk = kv.shape
    pad = (-T) % block
    if pad:
        kv = torch.nn.functional.pad(kv, (0, 0, 0, pad))
    Tp = T + pad
    return kv.reshape(S, H, Tp // block, block, dk).permute(2, 0, 1, 3, 4).contiguous()


def paged_to_dense(cache: torch.Tensor) -> torch.Tensor:
    """(NB, S, H, block, dk) → (S, H, dk, L)."""
    NB, S, H, block, dk = cache.shape
    return cache.permute(1, 2, 4, 0, 3).reshape(S, H, dk, NB * block)


def paged_cross_attention(q: torch.Tensor, k_paged: torch.Tensor,
                          v_paged: torch.Tensor,
                          valid_len: int) -> torch.Tensor:
    """Cross-attention decode step through the paged kernel: no positional
    bias; columns at or beyond `valid_len` are masked by the kernel's
    pos mask."""
    return paged_decode_attention(q, k_paged, v_paged, valid_len - 1)


def paged_cache_update(cache: torch.Tensor, step_kv: torch.Tensor,
                       pos: int) -> torch.Tensor:
    """Write one step's (S, H, 1, dk) K or V into the paged cache at pos.

    Writes IN PLACE (one (dk,) row per stream and head) and returns the
    same tensor."""
    block = cache.shape[3]
    cache[pos // block, :, :, pos % block, :] = step_kv[:, :, 0, :].to(cache.dtype)
    return cache


def paged_scale_update(scales: torch.Tensor, step_scale: torch.Tensor,
                       pos: int) -> torch.Tensor:
    """Write one step's (S, H, 1) fp32 scales into (S, NB, H, block) at pos.

    Writes IN PLACE and returns the same tensor."""
    block = scales.shape[3]
    scales[:, pos // block, :, pos % block] = step_scale[:, :, 0]
    return scales


def reference_decode_attention(q, k_cache, v_cache, pos: int, bias_row=None):
    """Dense reference with identical semantics (paged or (S, H, dk, L))."""
    if k_cache.ndim == 5:
        k_cache = paged_to_dense(k_cache)
        v_cache = paged_to_dense(v_cache)
    if q.ndim == 3:
        q = q[:, :, None, :]
    L = k_cache.shape[3]
    f32 = torch.float32
    logits = torch.einsum("shqd,shdk->shqk", q.to(f32), k_cache.to(f32))
    if bias_row is not None:
        logits = logits + bias_row[None, :, None, :]
    j = torch.arange(L, device=q.device)[None, None, None, :]
    logits = torch.where(j <= pos, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("shqk,shdk->shqd", p, v_cache.to(f32))
    return out[:, :, 0, :].to(q.dtype)
