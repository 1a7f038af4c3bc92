"""The decode caches' format, decided here alone: `layouts` maps the
config's (kv_quant, use_pallas_decode) to one self-cache layout and one
cross layout, which the T5 decoder keeps.

A self layout builds one layer's zeroed (k, v) caches (`empty`), computes
once a step what every layer's step needs (`prepare`), and writes the
step's K/V in place and attends over the caches (`attend`). A cross layout
packs each layer's projected (S, H, T, dk) memory once per segment batch
(`pack`) and attends over it. A quantized side is (values, fp32 row
scales); a zero scale makes an unwritten row add nothing. Every layout
reorders its streams along its own stream axis, and takes the position as
a 0-dim int64 tensor on the caches' device (`device_position`), so that
one CUDA graph of the step serves every position.
"""

from __future__ import annotations

import torch

from ..config.model import ModelConfig
from ..ops.decode_attention import (dense_to_paged, empty_paged_cache,
                                    empty_paged_scales, paged_cache_update,
                                    paged_cross_attention,
                                    paged_decode_attention, paged_scale_update,
                                    paged_slot)
from ..ops.int4_cross_attention import int4_cross_attention
from ..ops.kv_quant import (int4_decode_attention, int8_decode_attention,
                            quantize_kv, quantize_kv4, quantize_kv4_crosspack)
from .layers import (DTYPES, NEG_INF, dot_product_attention,
                     relative_position_bucket)


def device_position(pos, device) -> torch.Tensor:
    """pos as a 0-dim int64 tensor on `device`. A host int is filled in
    there, not copied from the host (which would wait for the stream)."""
    if isinstance(pos, torch.Tensor):
        return pos
    return torch.full((), pos, dtype=torch.long, device=device)


def step_bias(rel, pos: torch.Tensor, L: int) -> torch.Tensor:
    """(1, H, 1, L) bias from the decoder's bucket table `rel` plus the
    causal mask, for query position `pos`."""
    table = rel.weight
    j = torch.arange(L, device=table.device, dtype=torch.int32)
    buckets = relative_position_bucket(j - pos, False, rel.num_buckets,
                                       rel.max_distance)
    bias = table[buckets.long()].T[None, :, None, :]
    mask = torch.where(j > pos, NEG_INF, 0.0).to(table.dtype)
    return bias + mask[None, None, None, :]


class _Layout:
    """Stream reorders: a side's values lie on stream axis `axis`, its row
    scales (when `quantized`) on axis 0."""

    quantized = False
    axis = 0

    def _tensors(self, side):
        if self.quantized:
            return (side[0], self.axis), (side[1], 0)
        return ((side, self.axis),)

    def reorder(self, kvs, parent: torch.Tensor):
        """Per-layer (k, v) caches with their streams gathered at `parent`
        (a flat stream index), as new tensors."""
        def gather(side):
            out = tuple(x.index_select(a, parent) for x, a in self._tensors(side))
            return out if self.quantized else out[0]
        return [(gather(k), gather(v)) for k, v in kvs]

    def reorder_(self, kvs, parent: torch.Tensor) -> None:
        """`reorder` in place, one tensor at a time: the caches keep their
        storage (a graphed step's static state) and the temporary is one
        tensor."""
        for k, v in kvs:
            for x, a in (*self._tensors(k), *self._tensors(v)):
                x.copy_(x.index_select(a, parent))


class _SelfLayout(_Layout):
    values = None  # the values' dtype; None: the compute dtype

    def __init__(self, cfg: ModelConfig):
        self.kv_heads = cfg.decoder_kv_heads or cfg.num_heads
        self.groups = cfg.num_heads // self.kv_heads
        self.d_kv = cfg.d_kv
        self.values = self.values or DTYPES[cfg.compute_dtype]

    def _keys(self, kvs) -> torch.Tensor:
        """The first layer's K values."""
        return kvs[0][0][0] if self.quantized else kvs[0][0]


class _DenseSelf(_SelfLayout):
    """(S, H, L, dk / `packed`) values, (S, H, L) scales."""

    packed = 1

    def empty(self, streams: int, max_len: int, device):
        rows = (streams, self.kv_heads, max_len)

        def side():
            vals = torch.zeros((*rows, self.d_kv // self.packed),
                               dtype=self.values, device=device)
            if not self.quantized:
                return vals
            return vals, torch.zeros(rows, dtype=torch.float32, device=device)
        return side(), side()

    def prepare(self, rel, pos, kvs, kv_len: int):
        """→ (the step's bias row, grouped (1, Hkv, G, n) under grouped
        heads; the read horizon n: kv_len, 0 = all L)."""
        n = kv_len or self._keys(kvs).shape[2]
        bias = step_bias(rel, pos, n)
        if self.groups > 1:
            bias = bias.reshape(1, self.kv_heads, self.groups, n)
        return bias, n

    @staticmethod
    def _write(caches, pos, rows):
        for cache, row in zip(caches, rows):  # cache[:, :, pos] = row[:, :, 0]
            cache.index_copy_(2, pos.view(1), row.to(cache.dtype))


class DenseSelf(_DenseSelf):
    def attend(self, q, k, v, kv, pos, step):
        (bias, n), (ck, cv) = step, kv
        self._write(kv, pos, (k, v))
        return dot_product_attention(q, ck[:, :, :n], cv[:, :, :n], bias)


class DenseInt8Self(_DenseSelf):
    quantized, values = True, torch.int8

    def attend(self, q, k, v, kv, pos, step):
        bias, n = step
        self._write((*kv[0], *kv[1]), pos, (*quantize_kv(k), *quantize_kv(v)))
        # on the card the kernel reads the caches in place, rows up to pos
        return int8_decode_attention(q, *kv[0], *kv[1], bias, n=n, pos=pos)


class DenseInt4Self(_DenseSelf):
    """Interleaved nibbles, two values a byte."""

    quantized, values, packed = True, torch.uint8, 2

    def attend(self, q, k, v, kv, pos, step):
        (bias, n), caches = step, (*kv[0], *kv[1])
        self._write(caches, pos, (*quantize_kv4(k), *quantize_kv4(v)))
        return int4_decode_attention(q, *(c[:, :, :n] for c in caches), bias)


class _PagedSelf(_SelfLayout):
    """Pages (NB, S, H, block, dk), scales (S, NB, H, block)."""

    axis = 1

    def empty(self, streams: int, max_len: int, device):
        block = 64 if max_len <= 256 else 128  # 64-row pages for short decodes
        padded = -(-max_len // block) * block

        def side():
            vals = empty_paged_cache(streams, self.kv_heads, self.d_kv, padded,
                                     block, self.values, device)
            if not self.quantized:
                return vals
            return vals, empty_paged_scales(streams, self.kv_heads, padded, block,
                                            device)
        return side(), side()

    def prepare(self, rel, pos, kvs, kv_len: int):
        """→ (the kernel's bias arguments; the position's `paged_slot`, alike
        in every layer). The kernel reads the live pages only: kv_len plays
        no part."""
        return (dict(rel_table=rel.weight, dist_buckets=rel.distance_buckets,
                     rel_max_distance=rel.max_distance),
                paged_slot(pos, self._keys(kvs).shape[3]))


class PagedSelf(_PagedSelf):
    def attend(self, q, k, v, kv, pos, step):
        (bias, slot), (ck, cv) = step, kv
        paged_cache_update(ck, k, slot)
        paged_cache_update(cv, v, slot)
        return paged_decode_attention(q, ck, cv, pos, **bias)


class PagedInt8Self(_PagedSelf):
    quantized, values = True, torch.int8

    def attend(self, q, k, v, kv, pos, step):
        (bias, slot), ((kq, ks), (vq, vs)) = step, kv
        kq_s, ks_s = quantize_kv(k)
        vq_s, vs_s = quantize_kv(v)
        paged_cache_update(kq, kq_s, slot)
        paged_scale_update(ks, ks_s, slot)
        paged_cache_update(vq, vq_s, slot)
        paged_scale_update(vs, vs_s, slot)
        return paged_decode_attention(q, kq, vq, pos, k_scale=ks, v_scale=vs,
                                      **bias)


class DenseCross(_Layout):
    def pack(self, k, v):
        return k, v

    def attend(self, q, kv):
        return dot_product_attention(q, *kv, None)


class PagedCross(_Layout):
    """Pages of the largest block among 128, 64, ..., 8 that divides T (no
    padded columns); a T that none divides stays as projected and is
    attended and reordered as DenseCross's."""

    def pack(self, k, v):
        T = k.shape[-2]
        block = next((b for b in (128, 64, 32, 16, 8) if T % b == 0), None)
        if block is None:
            return k, v
        return dense_to_paged(k, block), dense_to_paged(v, block)

    def _tensors(self, side):
        return ((side, 1 if side.ndim == 5 else 0),)

    def attend(self, q, kv):
        k, v = kv
        if k.ndim == 4:
            return dot_product_attention(q, k, v, None)
        return paged_cross_attention(q, k, v, k.shape[0] * k.shape[3])


class Int8Cross(_Layout):
    quantized = True

    def pack(self, k, v):  # contiguous, as the int8 kernel reads them
        return quantize_kv(k.contiguous()), quantize_kv(v.contiguous())

    def attend(self, q, kv):
        return int8_decode_attention(q, *kv[0], *kv[1], None)


class Int4Cross(_Layout):
    """Interleaved nibbles, attended in plain PyTorch."""

    quantized = True

    def pack(self, k, v):
        return quantize_kv4(k), quantize_kv4(v)

    def attend(self, q, kv):
        return int4_decode_attention(q, *kv[0], *kv[1], None)


class Int4PackedCross(_Layout):
    """Split-half nibbles, (S, H, dk/2, T): the int4 cross kernel's."""

    quantized = True

    def pack(self, k, v):
        return quantize_kv4_crosspack(k), quantize_kv4_crosspack(v)

    def attend(self, q, kv):
        return int4_cross_attention(q, *kv[0], *kv[1])


# ModelConfig refuses ("int4", True)
LAYOUTS = {  # (kv_quant, use_pallas_decode) → (self layout, cross layout)
    ("none", False): (DenseSelf, DenseCross),
    ("none", True): (PagedSelf, PagedCross),
    ("int8", False): (DenseInt8Self, Int8Cross),
    ("int8", True): (PagedInt8Self, Int8Cross),
    ("int8c4", False): (DenseInt8Self, Int4Cross),
    ("int8c4", True): (PagedInt8Self, Int4Cross),
    ("int8c4p", False): (DenseInt8Self, Int4PackedCross),
    ("int8c4p", True): (PagedInt8Self, Int4PackedCross),
    ("int4", False): (DenseInt4Self, Int4Cross),
}


def layouts(cfg: ModelConfig):
    """→ (self layout, cross layout) of cfg's kv_quant and use_pallas_decode."""
    key = (cfg.kv_quant, bool(cfg.use_pallas_decode))
    if key not in LAYOUTS:
        raise ValueError(f"no decode caches for (kv_quant, use_pallas_decode) = {key}")
    self_layout, cross_layout = LAYOUTS[key]
    return self_layout(cfg), cross_layout()
