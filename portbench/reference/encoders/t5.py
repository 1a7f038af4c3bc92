"""Plain float32 T5 encoder of YourMT3 (T5.1.1 blocks on log-mel frames).

(B, T, F) features → input projection to d_model → absolute sinusoids
along time → num_encoder_layers × [RMS norm, self-attention over T with
T5's bidirectional bucketed relative bias (a table owned by the first
block, shared by all), RMS norm, gated-gelu FF] → final RMS norm → the
linear projection to the decoder's width, which is the identity where the
encoder's width already is d_model (proj_type "linear") → (B, 1, T,
d_model): one channel of decoder memory.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.model import F32, FP32, gelu, linear, mha, rms_norm, sinusoids

TABLE = "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"


def query_width(cfg: dict) -> int:
    return cfg["d_kv"]


def _supported(cfg: dict) -> None:
    if (cfg["encoder_abs_pos"], cfg["ff_act"], cfg["proj_type"]) != (
            "sinusoidal", "gated-gelu", "linear"):
        raise ValueError("the T5 reference covers sinusoidal positions, the "
                         "gated-gelu FF and the identity projection only")


def bidirectional_bucket(rel: torch.Tensor, num_buckets: int,
                         max_distance: int) -> torch.Tensor:
    """T5's bucketing of key - query distances in both directions, in fp32:
    half the buckets for keys before or at the query, half for keys after;
    in each half, exact distances below a quarter of the buckets, then
    log-spaced up to max_distance."""
    half = num_buckets // 2
    after = (rel > 0).to(rel.dtype) * half
    n = rel.abs()
    exact = half // 2
    f32 = lambda v: torch.full((), v, dtype=F32, device=rel.device)  # noqa: E731
    large = exact + (torch.log(n.to(F32) / f32(exact) + 1e-6)
                     / f32(np.float32(np.log(max_distance / exact)))
                     * (half - exact)).to(rel.dtype)
    return after + torch.where(n < exact, n, torch.clamp(large, max=half - 1))


def encode(p, feats, cfg, drop, num=FP32):
    """(B, T, F) features → (B, 1, T, d_model) decoder memory."""
    _supported(cfg)
    T = feats.shape[1]
    x = linear(feats, p["encoder.proj.weight"], num)
    x = drop(x + sinusoids(T, cfg["d_model"]).to(x.device)[None])
    pos = torch.arange(T, device=x.device, dtype=torch.int32)
    buckets = bidirectional_bucket(pos[None, :] - pos[:, None],
                                   cfg["rel_attn_num_buckets"], cfg["rel_attn_max_distance"])
    bias = p[TABLE][buckets.long()].permute(2, 0, 1)[None]
    for i in range(cfg["num_encoder_layers"]):
        pre = f"encoder.block.{i}.layer."
        h = rms_norm(x, p[pre + "0.layer_norm.weight"])
        x = x + drop(mha(p, pre + "0.SelfAttention", h, h, cfg["num_heads"], bias, num))
        h = rms_norm(x, p[pre + "1.layer_norm.weight"])
        f = gelu(linear(h, p[pre + "1.DenseReluDense.wi_0.weight"], num)) * linear(
            h, p[pre + "1.DenseReluDense.wi_1.weight"], num)
        x = x + drop(linear(drop(f), p[pre + "1.DenseReluDense.wo.weight"], num))
    return rms_norm(x, p["encoder.final_layer_norm.weight"])[:, None]


def shapes(cfg: dict, audio: dict) -> dict:
    """The encoder's names and shapes (the identity projection has none)."""
    _supported(cfg)
    dm, inner, dff = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["d_ff"]
    bins = audio["n_mels"] if audio["codec"] == "melspec" else audio["n_fft"] // 2 + 1
    s = {"encoder.proj.weight": (dm, bins), "encoder.final_layer_norm.weight": (dm,),
         TABLE: (cfg["rel_attn_num_buckets"], cfg["num_heads"])}
    for i in range(cfg["num_encoder_layers"]):
        pre = f"encoder.block.{i}.layer."
        for n in "qkv":
            s[f"{pre}0.SelfAttention.{n}.weight"] = (inner, dm)
        s[pre + "0.SelfAttention.o.weight"] = (dm, inner)
        s[pre + "0.layer_norm.weight"] = s[pre + "1.layer_norm.weight"] = (dm,)
        s[pre + "1.DenseReluDense.wi_0.weight"] = (dff, dm)
        s[pre + "1.DenseReluDense.wi_1.weight"] = (dff, dm)
        s[pre + "1.DenseReluDense.wo.weight"] = (dm, dff)
    return s
