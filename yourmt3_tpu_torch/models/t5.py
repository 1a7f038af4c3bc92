"""T5 encoder / decoder / multi-channel decoder (T5.1.1 semantics).

RMSNorm pre-norm, gated-gelu FF, bucketed relative position bias on a
table owned by the first layer, untied LM head, no attention scaling.
Module and parameter names follow the reference checkpoint naming
(`encoder.block.{i}.layer.0.SelfAttention.q.weight`, ...); the token
embedding (`shared`) and the LM head (`lm_head`) live on the full model
(models/ymt3.py), so the decoders here map embedded inputs to final-normed
hidden states.

Decoding uses explicit caches: `init_cross_kv` projects the encoder
memory once per segment batch, `decode_step` runs one token for every
stream and writes its K/V into the self caches in place. On the dense
self-cache paths the position may be a 0-dim tensor on the device, so
that one CUDA graph of the step serves every position. The paged
self-attention paths hand the bucket table to the decode-attention kernel
(ops/decode_attention.py), which builds the bias itself; with
kv_quant="int8c4p" the cross-attention runs through the int4 kernel
(ops/int4_cross_attention.py).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..config.model import ModelConfig
from ..ops.decode_attention import (dense_to_paged, paged_cache_update,
                                    paged_cross_attention,
                                    paged_decode_attention, paged_scale_update)
from ..ops.int4_cross_attention import int4_cross_attention
from ..ops.kv_quant import (int4_decode_attention, int8_decode_attention,
                            quantize_kv, quantize_kv4, quantize_kv4_crosspack)
from .layers import (DTYPES, NEG_INF, Dropout, FeedForward, MoEFeedForward,
                     MultiHeadAttention, QuantDense, RMSNorm, RelativePositionBias,
                     dot_product_attention, relative_position_bucket,
                     sinusoidal_positions)

KV = Tuple[torch.Tensor, torch.Tensor]

# kv_quant modes whose self cache is int8 ("int8c4"/"int8c4p" add int4
# cross K/V, plain and through the kernel)
INT8_SELF = ("int8", "int8c4", "int8c4p")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.compute_dtype]


def make_ff(cfg: ModelConfig, dtype: torch.dtype) -> nn.Module:
    """The layers' FF: ff_act="moe" is the reference's mixture of 8
    experts (d_ff each, top-2, tanh-gelu, fp32 weights that decoder
    weight quantization leaves alone); any other ff_act the dense FF."""
    if cfg.ff_act == "moe":
        return MoEFeedForward(8, cfg.d_model, cfg.d_ff, dtype)
    return FeedForward(cfg.d_model, cfg.d_ff, cfg.ff_act, dtype,
                       dropout_rate=cfg.dropout_rate)


def write_position(cache: torch.Tensor, pos, step: torch.Tensor) -> None:
    """cache[:, :, pos] = step[:, :, 0] for a dense (S, H, L, ...) cache and
    a (S, H, 1, ...) step. pos: a host int, or a 0-dim int64 tensor on the
    cache's device, which `index_copy_` reads there (a CUDA graph of the
    step then serves every position)."""
    if isinstance(pos, torch.Tensor):
        cache.index_copy_(2, pos.view(1), step.to(cache.dtype))
    else:
        cache[:, :, pos] = step[:, :, 0]


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: ModelConfig, num_kv_heads: Optional[int] = None,
                 relative_bias: Optional[RelativePositionBias] = None):
        super().__init__()
        dt = compute_dtype(cfg)
        self.SelfAttention = MultiHeadAttention(
            cfg.num_heads, cfg.d_kv, cfg.d_model, dt, num_kv_heads,
            relative_bias)
        self.layer_norm = RMSNorm(cfg.d_model, dt)


class T5LayerCrossAttention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        self.EncDecAttention = MultiHeadAttention(
            cfg.num_heads, cfg.d_kv, cfg.d_model, dt, cfg.decoder_kv_heads)
        self.layer_norm = RMSNorm(cfg.d_model, dt)


class T5LayerFF(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt = compute_dtype(cfg)
        self.DenseReluDense = make_ff(cfg, dt)
        self.layer_norm = RMSNorm(cfg.d_model, dt)


class T5EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig,
                 relative_bias: Optional[RelativePositionBias] = None):
        super().__init__()
        self.layer = nn.ModuleList([
            T5LayerSelfAttention(cfg, relative_bias=relative_bias),
            T5LayerFF(cfg)])
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        sa, ff = self.layer
        h = sa.layer_norm(x)
        x = x + self.dropout(sa.SelfAttention(h, h, bias))
        return x + self.dropout(ff.DenseReluDense(ff.layer_norm(x)))


class T5Encoder(nn.Module):
    """Continuous-input T5 encoder: (B, T, F) features → (B, T, D)."""

    def __init__(self, cfg: ModelConfig, in_features: int):
        super().__init__()
        self.cfg = cfg
        dt = compute_dtype(cfg)
        self.proj = QuantDense(in_features, cfg.d_model, dt)  # input_proj
        rel = RelativePositionBias(cfg.num_heads, cfg.rel_attn_num_buckets,
                                   cfg.rel_attn_max_distance,
                                   bidirectional=True, dtype=dt)
        self.block = nn.ModuleList(
            [T5EncoderLayer(cfg, rel if i == 0 else None)
             for i in range(cfg.num_encoder_layers)])
        self.final_layer_norm = RMSNorm(cfg.d_model, dt)
        self.dropout = Dropout(cfg.dropout_rate)
        if cfg.encoder_abs_pos == "learned":
            self.pos_embed = nn.Parameter(torch.empty(2048, cfg.d_model))
        elif cfg.encoder_abs_pos not in ("sinusoidal", "none"):
            raise ValueError(f"encoder_abs_pos={cfg.encoder_abs_pos!r} is not "
                             "a T5 encoder option")

    @property
    def rel_bias(self) -> RelativePositionBias:
        return self.block[0].layer[0].SelfAttention.relative_attention_bias

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.proj(feats)
        T = x.shape[1]
        if c.encoder_abs_pos == "sinusoidal":
            pos = torch.from_numpy(sinusoidal_positions(T, c.d_model))
            x = x + pos.to(device=x.device, dtype=x.dtype)[None]
        elif c.encoder_abs_pos == "learned":
            x = x + self.pos_embed[:T].to(x.dtype)[None]
        x = self.dropout(x)
        bias = self.rel_bias(T, T)
        for lyr in self.block:
            x = lyr(x, bias)
        return self.final_layer_norm(x)


class T5DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig,
                 relative_bias: Optional[RelativePositionBias] = None):
        super().__init__()
        self.cfg = cfg
        self.layer = nn.ModuleList([
            T5LayerSelfAttention(cfg, cfg.decoder_kv_heads, relative_bias),
            T5LayerCrossAttention(cfg),
            T5LayerFF(cfg)])
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, y, enc_out, self_bias):
        sa, ca, ff = self.layer
        h = sa.layer_norm(y)
        y = y + self.dropout(sa.SelfAttention(h, h, self_bias))
        y = y + self.dropout(ca.EncDecAttention(ca.layer_norm(y), enc_out, None))
        return y + self.dropout(ff.DenseReluDense(ff.layer_norm(y)))

    # ---- single-step decode with external caches ----------------------
    def decode_step(self, y: torch.Tensor, self_kv, pos, cross_kv,
                    step_bias, kv_len: int = 0):
        """y: (S, 1, D). pos: the lockstep position, a host int or, on the
        dense self-cache paths, a 0-dim int64 tensor on the caches' device
        (the paged kernels take it as a host scalar).
        step_bias: (1, H, 1, L) rel-bias row + causal mask (dense paths) or
        ("table", (buckets, H) table, distance buckets) for the kernel.
        kv_len: read horizon of the dense self-attention paths (0 = full
        L). The self caches are updated in place and returned."""
        cfg = self.cfg
        sa_l, ca_l, ff_l = self.layer
        sa = sa_l.SelfAttention
        h = sa_l.layer_norm(y)
        q = sa.split(sa.q(h), sa.num_heads)
        k_step = sa.split(sa.k(h), sa.kv_heads)
        v_step = sa.split(sa.v(h), sa.kv_heads)
        G = sa.num_heads // sa.kv_heads
        if G > 1:
            q = sa.group_queries(q)
            if not isinstance(step_bias, tuple):
                step_bias = sa.group_bias(step_bias, 1)
        ck, cv = self_kv
        if cfg.kv_quant in INT8_SELF and cfg.use_pallas_decode:
            # int8 paged: the kernel reads only the live int8 pages
            (kq, ksc), (vq, vsc) = ck, cv
            kq_s, ks_s = quantize_kv(k_step)
            vq_s, vs_s = quantize_kv(v_step)
            paged_cache_update(kq, kq_s, pos)
            paged_scale_update(ksc, ks_s, pos)
            paged_cache_update(vq, vq_s, pos)
            paged_scale_update(vsc, vs_s, pos)
            att = paged_decode_attention(
                q, kq, vq, pos, rel_table=step_bias[1],
                rel_max_distance=cfg.rel_attn_max_distance,
                k_scale=ksc, v_scale=vsc, dist_buckets=step_bias[2])
        elif cfg.kv_quant in INT8_SELF + ("int4",):
            # dense int8 (values (S,H,L,dk) int8) or int4 (interleaved
            # nibbles (S,H,L,dk/2) uint8), scales (S,H,L) fp32
            quant, attend = ((quantize_kv4, int4_decode_attention)
                             if cfg.kv_quant == "int4"
                             else (quantize_kv, int8_decode_attention))
            kq_s, ks_s = quant(k_step)
            vq_s, vs_s = quant(v_step)
            for cache, step in zip((*ck, *cv), (kq_s, ks_s, vq_s, vs_s)):
                write_position(cache, pos, step)
            n = kv_len or ck[0].shape[2]
            att = attend(q, ck[0][:, :, :n], ck[1][:, :, :n],
                         cv[0][:, :, :n], cv[1][:, :, :n], step_bias)
        elif cfg.use_pallas_decode:
            # bf16/fp32 paged
            paged_cache_update(ck, k_step, pos)
            paged_cache_update(cv, v_step, pos)
            att = paged_decode_attention(
                q, ck, cv, pos, rel_table=step_bias[1],
                rel_max_distance=cfg.rel_attn_max_distance,
                dist_buckets=step_bias[2])
        else:
            write_position(ck, pos, k_step)
            write_position(cv, pos, v_step)
            n = kv_len or ck.shape[2]
            att = dot_product_attention(q, ck[:, :, :n], cv[:, :, :n],
                                        step_bias)
        if G > 1:
            att = sa.ungroup_heads(att, 1)
        y = y + sa.o(sa.merge(att))

        ca = ca_l.EncDecAttention
        qc = ca.split(ca.q(ca_l.layer_norm(y)), ca.num_heads)
        if G > 1:
            qc = ca.group_queries(qc)
        if isinstance(cross_kv[0], tuple):
            (ckq, cks), (cvq, cvs) = cross_kv
            if cfg.kv_quant == "int8c4p":
                # split-half packed int4 through the kernel
                attc = int4_cross_attention(qc, ckq, cks, cvq, cvs)
            elif ckq.dtype == torch.uint8:
                attc = int4_decode_attention(qc, ckq, cks, cvq, cvs, None)
            else:
                attc = int8_decode_attention(qc, ckq, cks, cvq, cvs, None)
        elif cross_kv[0].ndim == 5:
            # paged cross: one kernel pass over the static encoder KV
            T = cross_kv[0].shape[0] * cross_kv[0].shape[3]
            attc = paged_cross_attention(qc, cross_kv[0], cross_kv[1], T)
        else:
            attc = dot_product_attention(qc, cross_kv[0], cross_kv[1], None)
        if G > 1:
            attc = ca.ungroup_heads(attc, 1)
        y = y + ca.o(ca.merge(attc))
        y = y + ff_l.DenseReluDense(ff_l.layer_norm(y))
        return y, (ck, cv)


class T5Decoder(nn.Module):
    """Decoder stack on embedded inputs: teacher-forced and step paths."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        rel = RelativePositionBias(cfg.num_heads, cfg.rel_attn_num_buckets,
                                   cfg.rel_attn_max_distance,
                                   bidirectional=False, dtype=torch.float32)
        self.block = nn.ModuleList(
            [T5DecoderLayer(cfg, rel if i == 0 else None)
             for i in range(cfg.num_decoder_layers)])
        self.final_layer_norm = RMSNorm(cfg.d_model, compute_dtype(cfg))
        self.dropout = Dropout(cfg.dropout_rate)

    @property
    def rel_bias(self) -> RelativePositionBias:
        return self.block[0].layer[0].SelfAttention.relative_attention_bias

    def causal_bias(self, L: int) -> torch.Tensor:
        rel = self.rel_bias(L, L)  # (1, H, L, L) fp32
        i = torch.arange(L, device=rel.device)[:, None]
        j = torch.arange(L, device=rel.device)[None, :]
        mask = torch.where(j > i, NEG_INF, 0.0).to(rel.dtype)
        return rel + mask[None, None]

    def forward(self, y: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        """(B, L, D) embedded ids + (B, T, D) memory → (B, L, D) hidden."""
        y = self.dropout(y)
        bias = self.causal_bias(y.shape[1])
        for lyr in self.block:
            y = lyr(y, enc_out, bias)
        return self.final_layer_norm(y)

    # ---- decode-time helpers -------------------------------------------
    def init_cross_kv(self, enc_out: torch.Tensor) -> List:
        cfg = self.cfg
        kvs = [blk.layer[1].EncDecAttention.project_kv(enc_out)
               for blk in self.block]
        if cfg.kv_quant == "int8c4p":
            return [(quantize_kv4_crosspack(k), quantize_kv4_crosspack(v))
                    for k, v in kvs]
        if cfg.kv_quant in ("int4", "int8c4"):
            return [(quantize_kv4(k), quantize_kv4(v)) for k, v in kvs]
        if cfg.kv_quant == "int8":
            return [(quantize_kv(k), quantize_kv(v)) for k, v in kvs]
        if cfg.use_pallas_decode:
            # paged layout for the cross pass of the kernel; block must
            # divide T exactly (no padded columns)
            T = enc_out.shape[-2]
            block = next((b for b in (128, 64, 32, 16, 8) if T % b == 0), None)
            if block is not None:
                kvs = [(dense_to_paged(k, block), dense_to_paged(v, block))
                       for k, v in kvs]
        return kvs

    def step_bias(self, pos, L: int) -> torch.Tensor:
        """(1, H, 1, L) bias + causal mask for query position `pos` (a host
        int or a 0-dim int64 tensor on the table's device)."""
        table = self.rel_bias.weight
        j = torch.arange(L, device=table.device, dtype=torch.int32)
        buckets = relative_position_bucket(
            j - pos, bidirectional=False,
            num_buckets=self.cfg.rel_attn_num_buckets,
            max_distance=self.cfg.rel_attn_max_distance)
        bias = table[buckets.long()].T[None, :, None, :]  # (1, H, 1, L)
        mask = torch.where(j > pos, NEG_INF, 0.0).to(table.dtype)
        return bias + mask[None, None, None, :]

    def decode_step(self, y: torch.Tensor, pos, self_kvs: List,
                    cross_kvs: List, kv_len: int = 0):
        """y: (S, 1, D) embedded current tokens; pos: host int, or a 0-dim
        int64 tensor on the caches' device on the dense self-cache paths.
        → ((S, 1, D) final-normed hidden, self caches)."""
        if self.cfg.use_pallas_decode:
            rel = self.rel_bias
            bias = ("table", rel.weight, rel.distance_buckets)
        else:
            skv = self_kvs[0][0]
            if isinstance(skv, tuple):
                skv = skv[0]
            L = skv.shape[0] * skv.shape[3] if skv.ndim == 5 else skv.shape[2]
            bias = self.step_bias(pos, kv_len or L)
        new_kvs = []
        for lyr, skv, ckv in zip(self.block, self_kvs, cross_kvs):
            y, nkv = lyr.decode_step(y, skv, pos, ckv, bias, kv_len=kv_len)
            new_kvs.append(nkv)
        return self.final_layer_norm(y), new_kvs


class MultiChannelT5Decoder(T5Decoder):
    """C decoder streams with shared weights; channel c cross-attends its
    own memory slice. Channels fold into the batch: (B, C, ...) →
    (B·C, ...), so the parameters are those of one T5Decoder."""

    def forward(self, y: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        """y: (B, C, L, D) embedded; enc_out: (B, C, T, D) → (B, C, L, D)."""
        B, C, L, D = y.shape
        T = enc_out.shape[2]
        h = super().forward(y.reshape(B * C, L, D),
                            enc_out.reshape(B * C, T, enc_out.shape[3]))
        return h.reshape(B, C, L, D)

    def init_cross_kv(self, enc_out: torch.Tensor) -> List:
        B, C, T, D = enc_out.shape
        return super().init_cross_kv(enc_out.reshape(B * C, T, D))
