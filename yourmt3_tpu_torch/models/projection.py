"""Encoder→decoder projection.

Two branches are ported:
- the T5 encoder's: (B, T, D) output with D == d_model and proj_type
  "linear" is the identity, replicated over the decoding channels;
- the Perceiver-TF encoder's "group-linear": (B, T, K, D_lat) latents
  are cut into C groups of K/C, each group flattened and projected to
  d_model by one bias-free linear layer → (B, C, T, d_model). As in the
  reference the projection computes in bf16 whatever the compute dtype,
  so the decoder memory is bf16.
The other branches (mlp, depthwise-conv, linear-forced, group-conv) are
ROADMAP Queue 1 item 16.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config.model import ModelConfig
from .layers import QuantDense

UNPORTED = ("proj_type={!r} is not ported yet for the {} encoder (ROADMAP "
            "Queue 1 item 16)")


class EncoderProjection(nn.Module):
    """Encoder output → decoder memory (B, C, T, d_model)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.grouped = cfg.encoder_type == "perceiver-tf"
        if self.grouped:
            if cfg.proj_type == "group-conv":
                raise NotImplementedError(UNPORTED.format(cfg.proj_type,
                                                          cfg.encoder_type))
            C, K = cfg.num_channels, cfg.ptf_num_latents
            if K % C:
                raise ValueError(f"num_latents {K} not divisible by channels {C}")
            self.group_proj = QuantDense((K // C) * cfg.ptf_d_latent,
                                         cfg.d_model, torch.bfloat16)
        elif cfg.proj_type != "linear":
            raise NotImplementedError(UNPORTED.format(cfg.proj_type,
                                                      cfg.encoder_type))

    def forward(self, enc_out: torch.Tensor) -> torch.Tensor:
        C = self.cfg.num_channels
        if self.grouped:
            B, T, K, D = enc_out.shape
            h = enc_out.reshape(B, T, C, (K // C) * D).transpose(1, 2)
            return self.group_proj(h)
        if enc_out.ndim != 3 or enc_out.shape[-1] != self.cfg.d_model:
            raise NotImplementedError(
                "only the (B, T, d_model) identity projection is ported for "
                f"this encoder; got {tuple(enc_out.shape)} (ROADMAP Queue 1 "
                "item 16)")
        h = enc_out[:, None]
        return h if C == 1 else h.expand(-1, C, -1, -1)
