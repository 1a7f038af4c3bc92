"""Perceiver-TF encoder: spectral cross-attention onto latents, then
alternating temporal and spectral self-attention.

(B, T, F) features → conv pre-encoder (B, T, F', C) → spectral_proj to
d_latent → per frame, K learned latents cross-attend the F' spectral
tokens (query residual kept) → absolute sinusoids and the trainable
`pos_emb` added along time → `ptf_num_blocks` × [temporal SA over T for
each latent, spectral SA over K for each frame], each folding the other
axis into the batch → final RMSNorm → (B, T, K, D).

Attention has d_latent // 32 heads and, as everywhere in T5, no 1/√d
scale; the FFs are plain tanh-gelu (`wi`, `wo`). Module names follow the
reference checkpoint naming, so the JAX importer's inverse rules give the
state_dict keys (weights.py). The MoE FF and the rope/alibi positions are
not ported (ROADMAP Queue 1 item 16).
"""

from __future__ import annotations

import torch
from torch import nn

from ..config.model import ModelConfig
from .conv_block import ConvPreEncoder
from .layers import (DTYPES, Dropout, FeedForward, MultiHeadAttention, QuantDense,
                     RMSNorm, sinusoidal_positions)

UNPORTED = ("{} is not ported yet (ROADMAP Queue 1 item 16: other encoders "
            "and options)")


def _heads(d: int) -> int:
    return max(1, d // 32)


class PTFBlockAttention(nn.Module):
    """Pre-norm self-attention + FF over the last two axes (L, D)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        dt, d = DTYPES[cfg.compute_dtype], cfg.ptf_d_latent
        h = _heads(d)
        self.norm1 = RMSNorm(d, dt)
        self.attention = MultiHeadAttention(h, d // h, d, dt)
        self.norm2 = RMSNorm(d, dt)
        self.mlp = FeedForward(d, 4 * d, cfg.ptf_ff_act, dt,
                               dropout_rate=cfg.dropout_rate)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.dropout(self.attention(h, h, None))
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
        if cfg.ptf_num_moe_experts > 0:
            raise NotImplementedError(UNPORTED.format(
                f"ptf_num_moe_experts={cfg.ptf_num_moe_experts} (MoE FF)"))
        if cfg.ptf_pos_enc != "trainable":
            raise NotImplementedError(UNPORTED.format(
                f"ptf_pos_enc={cfg.ptf_pos_enc!r}"))
        self.cfg = cfg
        dt, d = DTYPES[cfg.compute_dtype], cfg.ptf_d_latent
        if cfg.use_conv_pre_encoder:
            self.pre_encoder = ConvPreEncoder(cfg.conv_channels, dtype=dt)
        tok_dim = cfg.conv_channels if cfg.use_conv_pre_encoder else 1
        self.spectral_proj = QuantDense(tok_dim, d, dt)
        self.latent_array = nn.Parameter(torch.empty(cfg.ptf_num_latents, d))
        self.sca = SpectralCrossAttention(cfg)
        self.temporal_blocks = nn.ModuleList(
            [PTFBlockAttention(cfg) for _ in range(cfg.ptf_num_blocks)])
        self.spectral_blocks = nn.ModuleList(
            [PTFBlockAttention(cfg) for _ in range(cfg.ptf_num_blocks)])
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
        z = z + self.pos_emb[:T].to(dt)[None, :, None, :]

        for tb, sb in zip(self.temporal_blocks, self.spectral_blocks):
            zt = tb(z.transpose(1, 2).reshape(B * K, T, D))
            z = zt.reshape(B, K, T, D).transpose(1, 2)
            z = sb(z.reshape(B * T, K, D)).reshape(B, T, K, D)
        return self.final_layer_norm(z)
