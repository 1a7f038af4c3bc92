"""Encoder→decoder projection: encoder output → decoder memory
(B, C, T, d_model).

- The T5 and conformer encoders give (B, T, D) with D == d_model:
  "mlp" is proj_in → tanh-gelu → proj_out; "depthwise-conv" a depthwise
  conv over time (k 3, "SAME", `dw_conv`) then `pw_proj`;
  "linear-forced" one linear layer `proj`; any other proj_type the
  identity. The result is replicated over the C decoding channels.
- The Perceiver-TF encoder gives (B, T, K, D_lat): the K latents are cut
  into C groups of K/C, each group flattened to g·D_lat ("group-linear");
  "group-conv" first runs a depthwise conv over time (k 3, "SAME",
  `group_dw_conv`) on each group's (T, g·D_lat); then `group_proj` maps
  each group to d_model → (B, C, T, d_model).
As in the reference, every layer here computes in bf16 whatever the
compute dtype, so the memory is bf16 unless the projection is the
identity.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config.model import ModelConfig
from .layers import ACTIVATIONS, DepthwiseConv1d, QuantDense

BF16 = torch.bfloat16


class EncoderProjection(nn.Module):
    """Encoder output → decoder memory (B, C, T, d_model)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.grouped = cfg.encoder_type == "perceiver-tf"
        d = cfg.d_model
        if self.grouped:
            C, K = cfg.num_channels, cfg.ptf_num_latents
            if K % C:
                raise ValueError(f"num_latents {K} not divisible by channels {C}")
            gd = (K // C) * cfg.ptf_d_latent
            if cfg.proj_type == "group-conv":
                self.group_dw_conv = DepthwiseConv1d(gd, 3, BF16)
            self.group_proj = QuantDense(gd, d, BF16)
        elif cfg.proj_type == "mlp":
            self.proj_in = QuantDense(d, d, BF16)
            self.proj_out = QuantDense(d, d, BF16)
        elif cfg.proj_type == "depthwise-conv":
            self.dw_conv = DepthwiseConv1d(d, 3, BF16)
            self.pw_proj = QuantDense(d, d, BF16)
        elif cfg.proj_type == "linear-forced":
            self.proj = QuantDense(d, d, BF16)

    def forward(self, enc_out: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        C = c.num_channels
        if self.grouped:
            B, T, K, D = enc_out.shape
            h = enc_out.reshape(B, T, C, (K // C) * D).transpose(1, 2)
            if c.proj_type == "group-conv":
                gd = h.shape[-1]
                h = self.group_dw_conv(h.reshape(B * C, T, gd)).reshape(B, C, T, gd)
            return self.group_proj(h)
        if c.proj_type == "mlp":
            h = self.proj_out(ACTIVATIONS["gelu"](self.proj_in(enc_out)))
        elif c.proj_type == "depthwise-conv":
            h = self.pw_proj(self.dw_conv(enc_out))
        elif c.proj_type == "linear-forced":
            h = self.proj(enc_out)
        else:
            h = enc_out
        h = h[:, None]
        return h if C == 1 else h.expand(-1, C, -1, -1)
