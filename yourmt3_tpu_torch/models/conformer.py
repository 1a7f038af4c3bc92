"""Conformer encoder: (B, T, F) features → (B, T, d_model).

`proj` (input_proj) lifts the mel features to d_model; the absolute
sinusoid is added at the input ("sinusoidal") and, with
"sinusoidal_per_block", again at every block input after the first. Each
of `num_encoder_layers` blocks is the half-FFN sandwich

    x + ½·FFN(x) → x + MHA(RMSNorm(x)) with the bidirectional relative
    bias → x + ConvModule(x) → x + ½·FFN(x) → RMSNorm

where FFN is RMSNorm → wi → SiLU → dropout → wo, and the conv module is
RMSNorm → pointwise_in (d → 2d) → GLU → depthwise conv (k 15, "SAME") →
conv_norm → SiLU → pointwise_out. One relative-bias table serves every
block. As in the reference, the encoder has no pre-encoder (whatever
`use_conv_pre_encoder` says), no learned positions, no dropout outside
the FFNs and no final norm of its own.

Parameter names are those the reference importer's inverse rules give:
the T5 rules come first there, so the input projection is
`encoder.proj.weight` and the bias table
`encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight`;
the blocks are `encoder.conformer.{i}.*`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config.model import ModelConfig
from .layers import (DTYPES, DepthwiseConv1d, Dropout, MultiHeadAttention,
                     QuantDense, RelativePositionBias, RMSNorm,
                     sinusoidal_positions)


class ConformerConvModule(nn.Module):
    def __init__(self, d_model: int, dtype: torch.dtype, kernel_size: int = 15):
        super().__init__()
        self.norm = RMSNorm(d_model, dtype)
        self.pointwise_in = QuantDense(d_model, 2 * d_model, dtype)
        self.depthwise = DepthwiseConv1d(d_model, kernel_size, dtype)
        self.conv_norm = RMSNorm(d_model, dtype)
        self.pointwise_out = QuantDense(d_model, d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.glu(self.pointwise_in(self.norm(x)), dim=-1)
        h = self.conv_norm(self.depthwise(h))
        return self.pointwise_out(F.silu(h))


class ConformerFFN(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dropout_rate: float,
                 dtype: torch.dtype):
        super().__init__()
        self.norm = RMSNorm(d_model, dtype)
        self.wi = QuantDense(d_model, d_ff, dtype)
        self.dropout = Dropout(dropout_rate)
        self.wo = QuantDense(d_ff, d_model, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(self.dropout(F.silu(self.wi(self.norm(x)))))


class ConformerBlock(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt, d = DTYPES[cfg.compute_dtype], cfg.d_model
        self.ffn1 = ConformerFFN(d, cfg.d_ff, cfg.dropout_rate, dt)
        self.attn_norm = RMSNorm(d, dt)
        self.attention = MultiHeadAttention(cfg.num_heads, cfg.d_kv, d, dt)
        self.conv = ConformerConvModule(d, dt)
        self.ffn2 = ConformerFFN(d, cfg.d_ff, cfg.dropout_rate, dt)
        self.final_norm = RMSNorm(d, dt)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = x + 0.5 * self.ffn1(x)
        h = self.attn_norm(x)
        x = x + self.attention(h, h, bias)
        x = x + self.conv(x)
        x = x + 0.5 * self.ffn2(x)
        return self.final_norm(x)


def _at(path: str, module: nn.Module) -> nn.Module:
    """Nest `module` under the dotted `path` of containers that hold nothing
    else (a digit is a list index), so its parameters take that name."""
    for part in reversed(path.split(".")):
        module = (nn.ModuleList([module]) if part == "0"
                  else nn.ModuleDict({part: module}))
    return module


class ConformerEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig, in_features: int):
        super().__init__()
        self.cfg = cfg
        dt = DTYPES[cfg.compute_dtype]
        self.proj = QuantDense(in_features, cfg.d_model, dt)  # input_proj
        rel = RelativePositionBias(cfg.num_heads, cfg.rel_attn_num_buckets,
                                   cfg.rel_attn_max_distance,
                                   bidirectional=True, dtype=dt)
        # the checkpoint name of the shared table:
        # block.0.layer.0.SelfAttention.relative_attention_bias
        self.block = _at("0.layer.0.SelfAttention.relative_attention_bias", rel)
        self.conformer = nn.ModuleList(
            [ConformerBlock(cfg) for _ in range(cfg.num_encoder_layers)])

    @property
    def rel_bias(self) -> RelativePositionBias:
        return self.block[0]["layer"][0]["SelfAttention"]["relative_attention_bias"]

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        x = self.proj(feats)
        T = x.shape[1]
        pos = None
        if c.encoder_abs_pos in ("sinusoidal", "sinusoidal_per_block"):
            pos = torch.from_numpy(sinusoidal_positions(T, c.d_model)).to(
                device=x.device, dtype=x.dtype)[None]
            x = x + pos
        bias = self.rel_bias(T, T)
        for i, blk in enumerate(self.conformer):
            if c.encoder_abs_pos == "sinusoidal_per_block" and i > 0:
                x = x + pos
            x = blk(x, bias)
        return x
