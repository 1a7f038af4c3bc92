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
stream and writes its K/V into the self caches in place, at a position
held in a 0-dim tensor on the device (one CUDA graph of the step serves
every position). The decoder keeps the self and cross cache layouts of
its config (models/kv_cache.py), which lay out, write and attend over the
caches, through the decode kernels where the layout has one.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..config.model import ModelConfig
from . import kv_cache
from .layers import (DTYPES, NEG_INF, Dropout, FeedForward, MoEFeedForward,
                     MultiHeadAttention, QuantDense, RMSNorm, RelativePositionBias,
                     sinusoidal_positions)


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
    def __init__(self, cfg: ModelConfig, caches,
                 relative_bias: Optional[RelativePositionBias] = None):
        super().__init__()
        self.self_cache, self.cross_cache = caches  # kv_cache.layouts(cfg)
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
    def decode_step(self, y: torch.Tensor, self_kv, pos: torch.Tensor,
                    cross_kv, step):
        """y: (S, 1, D). pos: the lockstep position, a 0-dim int64 tensor
        on the caches' device. step: what the self layout's `prepare`
        computed for this step. The self caches are updated in place."""
        sa_l, ca_l, ff_l = self.layer
        sa = sa_l.SelfAttention
        h = sa_l.layer_norm(y)
        q = sa.split(sa.q(h), sa.num_heads)
        k_step = sa.split(sa.k(h), sa.kv_heads)
        v_step = sa.split(sa.v(h), sa.kv_heads)
        G = sa.num_heads // sa.kv_heads
        if G > 1:
            q = sa.group_queries(q)
        att = self.self_cache.attend(q, k_step, v_step, self_kv, pos, step)
        if G > 1:
            att = sa.ungroup_heads(att, 1)
        y = y + sa.o(sa.merge(att))

        ca = ca_l.EncDecAttention
        qc = ca.split(ca.q(ca_l.layer_norm(y)), ca.num_heads)
        if G > 1:
            qc = ca.group_queries(qc)
        attc = self.cross_cache.attend(qc, cross_kv)
        if G > 1:
            attc = ca.ungroup_heads(attc, 1)
        y = y + ca.o(ca.merge(attc))
        return y + ff_l.DenseReluDense(ff_l.layer_norm(y))


class T5Decoder(nn.Module):
    """Decoder stack on embedded inputs: teacher-forced and step paths."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        rel = RelativePositionBias(cfg.num_heads, cfg.rel_attn_num_buckets,
                                   cfg.rel_attn_max_distance,
                                   bidirectional=False, dtype=torch.float32)
        self.self_cache, self.cross_cache = kv_cache.layouts(cfg)
        caches = (self.self_cache, self.cross_cache)
        self.block = nn.ModuleList(
            [T5DecoderLayer(cfg, caches, rel if i == 0 else None)
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
        """(S, T, D) memory → per-layer cross K/V in the cross layout."""
        kvs = [blk.layer[1].EncDecAttention.project_kv(enc_out)
               for blk in self.block]
        return [self.cross_cache.pack(k, v) for k, v in kvs]

    def decode_step(self, y: torch.Tensor, pos: torch.Tensor, self_kvs: List,
                    cross_kvs: List, kv_len: int = 0):
        """y: (S, 1, D) embedded current tokens; pos: a 0-dim int64 tensor
        on the caches' device; kv_len: read horizon of the dense self
        caches (0 = all L). → ((S, 1, D) final-normed hidden, self caches,
        updated in place)."""
        step = self.self_cache.prepare(self.rel_bias, pos, self_kvs, kv_len)
        for lyr, skv, ckv in zip(self.block, self_kvs, cross_kvs):
            y = lyr.decode_step(y, skv, pos, ckv, step)
        return self.final_layer_norm(y), self_kvs


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
