"""Perceiver-TF encoder: spectral cross-attention onto latents, then
alternating temporal and spectral self-attention.

(B, T, F) features → conv pre-encoder (B, T, F', C) → spectral_proj to
d_latent → per frame, K learned latents cross-attend the F' spectral
tokens (query residual kept) → absolute sinusoids and the trainable
`pos_emb` (ptf_pos_enc="trainable") added along time →
`ptf_num_blocks` × [temporal SA over T for each latent, spectral SA over
K for each frame], each folding the other axis into the batch → final
RMSNorm → (B, T, K, D).

Attention has d_latent // 32 heads and, as everywhere in T5, no 1/√d
scale. With ptf_pos_enc "rope" or "alibi" there is no `pos_emb`: the
temporal blocks rotate q and k, or add the ALiBi distance bias, instead.
The blocks' FF is plain tanh-gelu (`wi`, `wo`), or the top-k
mixture-of-experts FF when ptf_num_moe_experts > 0; the cross-attention's
FF is always dense. Module names follow the reference checkpoint naming,
so the JAX importer's inverse rules give the state_dict keys (weights.py).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config.model import ModelConfig
from .conv_block import ConvPreEncoder
from .layers import (DTYPES, Dropout, FeedForward, MoEFeedForward,
                     MultiHeadAttention, QuantDense, RMSNorm, alibi_bias,
                     sinusoidal_positions)

POS_MODES = ("trainable", "rope", "alibi")


def _heads(d: int) -> int:
    return max(1, d // 32)


class PTFBlockAttention(nn.Module):
    """Pre-norm self-attention + FF over the last two axes (L, D).

    pos_mode: "none", "rope" (rotary q/k) or "alibi" (additive distance
    bias); the encoder sets it on the temporal blocks only."""

    def __init__(self, cfg: ModelConfig, pos_mode: str = "none"):
        super().__init__()
        dt, d = DTYPES[cfg.compute_dtype], cfg.ptf_d_latent
        h = _heads(d)
        self.pos_mode = pos_mode
        self.norm1 = RMSNorm(d, dt)
        self.attention = MultiHeadAttention(h, d // h, d, dt,
                                            use_rope=pos_mode == "rope")
        self.norm2 = RMSNorm(d, dt)
        if cfg.ptf_num_moe_experts > 0:
            self.mlp = MoEFeedForward(cfg.ptf_num_moe_experts, d, 4 * d, dt,
                                      top_k=cfg.ptf_moe_topk,
                                      act=cfg.ptf_ff_act)
        else:
            self.mlp = FeedForward(d, 4 * d, cfg.ptf_ff_act, dt,
                                   dropout_rate=cfg.dropout_rate)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        bias = None
        if self.pos_mode == "alibi":
            L = x.shape[1]
            bias = alibi_bias(self.attention.num_heads, L, L, x.device)
        x = x + self.dropout(self.attention(h, h, bias))
        return x + self.dropout(self.mlp(self.norm2(x)))


class SpectralCrossAttention(nn.Module):
    """K latents (queries) attend the F' spectral tokens of one frame."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt, d = DTYPES[cfg.compute_dtype], cfg.ptf_d_latent
        h = _heads(d)
        self.residual = cfg.ptf_sca_use_query_residual
        self.norm_q = RMSNorm(d, dt)
        self.norm_kv = RMSNorm(d, dt)
        self.attention = MultiHeadAttention(h, d // h, d, dt)
        self.ff_norm = RMSNorm(d, dt)
        self.ff = FeedForward(d, 4 * d, cfg.ptf_ff_act, dt,
                              dropout_rate=cfg.dropout_rate)

    def forward(self, q: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
        h = self.attention(self.norm_q(q), self.norm_kv(tok), None)
        z = q + h if self.residual else h
        return z + self.ff(self.ff_norm(z))


class PerceiverTFEncoder(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.ptf_pos_enc not in POS_MODES:
            raise ValueError(f"ptf_pos_enc must be one of {POS_MODES}, got "
                             f"{cfg.ptf_pos_enc!r}")
        self.cfg = cfg
        dt, d = DTYPES[cfg.compute_dtype], cfg.ptf_d_latent
        if cfg.use_conv_pre_encoder:
            self.pre_encoder = ConvPreEncoder(cfg.conv_channels, dtype=dt)
        tok_dim = cfg.conv_channels if cfg.use_conv_pre_encoder else 1
        self.spectral_proj = QuantDense(tok_dim, d, dt)
        self.latent_array = nn.Parameter(torch.empty(cfg.ptf_num_latents, d))
        self.sca = SpectralCrossAttention(cfg)
        pos_mode = "none" if cfg.ptf_pos_enc == "trainable" else cfg.ptf_pos_enc
        self.temporal_blocks = nn.ModuleList(
            [PTFBlockAttention(cfg, pos_mode) for _ in range(cfg.ptf_num_blocks)])
        self.spectral_blocks = nn.ModuleList(
            [PTFBlockAttention(cfg) for _ in range(cfg.ptf_num_blocks)])
        if cfg.ptf_pos_enc == "trainable":
            self.pos_emb = nn.Parameter(torch.empty(1024, d))
        self.final_layer_norm = RMSNorm(d, dt)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, T, F) → (B, T, K, D) latent grid."""
        c = self.cfg
        dt = DTYPES[c.compute_dtype]
        B, T, _ = feats.shape
        x = feats.to(dt)
        tok = self.pre_encoder(x) if c.use_conv_pre_encoder else x[..., None]
        tok = self.spectral_proj(tok)  # (B, T, F', D)
        Fp, K, D = tok.shape[2], c.ptf_num_latents, c.ptf_d_latent

        tok = tok.reshape(B * T, Fp, D)
        q = self.latent_array.to(dt)[None].expand(B * T, K, D)
        z = self.sca(q, tok).reshape(B, T, K, D)

        if c.encoder_abs_pos == "sinusoidal":
            pos = torch.from_numpy(sinusoidal_positions(T, D))
            z = z + pos.to(device=z.device, dtype=dt)[None, :, None, :]
        if c.ptf_pos_enc == "trainable":
            z = z + self.pos_emb[:T].to(dt)[None, :, None, :]

        for tb, sb in zip(self.temporal_blocks, self.spectral_blocks):
            zt = tb(z.transpose(1, 2).reshape(B * K, T, D))
            z = zt.reshape(B, K, T, D).transpose(1, 2)
            z = sb(z.reshape(B * T, K, D)).reshape(B, T, K, D)
        return self.final_layer_norm(z)
