"""Weights from the JAX package's param tree into the port's modules.

The port names its parameters after the reference checkpoint naming
(HF T5 style), which is what the JAX package's importer reads and its
`reference_style_state_dict` writes. `state_dict_from_jax` applies its
inverse import rules for the T5 family, the Perceiver-TF encoder and the
group projection (flax path → torch name, with flax (in, out) kernels
transposed to torch's (out, in) and (kh, kw, in, out) conv kernels to
(out, in, kh, kw)), so its result loads into `models.ymt3.YMT3` with
`load_state_dict(strict=True)`. JAX's derived `qweights` collection (the
decode-time quantized decoder weights) is skipped: the port derives its
own from the fp32 master.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

# flax path regex → (torch name template, transform); "t" = transpose 2-D,
# "conv" = flax (kh, kw, in, out) → torch (out, in, kh, kw)
T5_INVERSE_RULES: List[Tuple[str, str, str]] = [
    # encoder
    (r"encoder/layer_(\d+)/attn/([qkvo])/kernel",
     "encoder.block.{0}.layer.0.SelfAttention.{1}.weight", "t"),
    (r"encoder/layer_(\d+)/norm_attn/scale",
     "encoder.block.{0}.layer.0.layer_norm.weight", "none"),
    (r"encoder/layer_(\d+)/ff/(wi_0|wi_1|wi|wo)/kernel",
     "encoder.block.{0}.layer.1.DenseReluDense.{1}.weight", "t"),
    (r"encoder/layer_(\d+)/norm_ff/scale",
     "encoder.block.{0}.layer.1.layer_norm.weight", "none"),
    (r"encoder/rel_bias/rel_embedding",
     "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
     "none"),
    (r"encoder/final_norm/scale", "encoder.final_layer_norm.weight", "none"),
    (r"encoder/input_proj/kernel", "encoder.proj.weight", "t"),
    (r"encoder/pos_embed", "encoder.pos_embed", "none"),
    # decoder (single- or multi-channel nesting)
    (r"decoder/(?:decoder/)?layer_(\d+)/self_attn/([qkvo])/kernel",
     "decoder.block.{0}.layer.0.SelfAttention.{1}.weight", "t"),
    (r"decoder/(?:decoder/)?layer_(\d+)/norm_self/scale",
     "decoder.block.{0}.layer.0.layer_norm.weight", "none"),
    (r"decoder/(?:decoder/)?layer_(\d+)/cross_attn/([qkvo])/kernel",
     "decoder.block.{0}.layer.1.EncDecAttention.{1}.weight", "t"),
    (r"decoder/(?:decoder/)?layer_(\d+)/norm_cross/scale",
     "decoder.block.{0}.layer.1.layer_norm.weight", "none"),
    (r"decoder/(?:decoder/)?layer_(\d+)/ff/(wi_0|wi_1|wi|wo)/kernel",
     "decoder.block.{0}.layer.2.DenseReluDense.{1}.weight", "t"),
    (r"decoder/(?:decoder/)?layer_(\d+)/norm_ff/scale",
     "decoder.block.{0}.layer.2.layer_norm.weight", "none"),
    (r"decoder/(?:decoder/)?rel_bias/rel_embedding",
     "decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
     "none"),
    (r"decoder/(?:decoder/)?final_norm/scale",
     "decoder.final_layer_norm.weight", "none"),
    (r"decoder/(?:decoder/)?embed/embedding", "shared.weight", "none"),
    (r"decoder/(?:decoder/)?lm_head/kernel", "lm_head.weight", "t"),
]

# Perceiver-TF encoder (dense FF) and the group projection; its final norm
# is `encoder/final_norm`, which the T5 rule above maps first
PERCEIVER_INVERSE_RULES: List[Tuple[str, str, str]] = [
    (r"encoder/conv_pre/block_(\d+)/(conv_down|conv_a|conv_b)/kernel",
     "encoder.pre_encoder.block.{0}.{1}.weight", "conv"),
    (r"encoder/conv_pre/block_(\d+)/(conv_down|conv_a|conv_b)/bias",
     "encoder.pre_encoder.block.{0}.{1}.bias", "none"),
    (r"encoder/spectral_proj/kernel", "encoder.spectral_proj.weight", "t"),
    (r"encoder/latents", "encoder.latent_array", "none"),
    (r"encoder/time_pos", "encoder.pos_emb", "none"),
    (r"encoder/sca_norm_q/scale", "encoder.sca.norm_q.weight", "none"),
    (r"encoder/sca_norm_kv/scale", "encoder.sca.norm_kv.weight", "none"),
    (r"encoder/sca/([qkvo])/kernel", "encoder.sca.attention.{0}.weight", "t"),
    (r"encoder/sca_ff_norm/scale", "encoder.sca.ff_norm.weight", "none"),
    (r"encoder/sca_ff/(wi|wo)/kernel", "encoder.sca.ff.{0}.weight", "t"),
    (r"encoder/(temporal|spectral)_(\d+)/norm_attn/scale",
     "encoder.{0}_blocks.{1}.norm1.weight", "none"),
    (r"encoder/(temporal|spectral)_(\d+)/attn/([qkvo])/kernel",
     "encoder.{0}_blocks.{1}.attention.{2}.weight", "t"),
    (r"encoder/(temporal|spectral)_(\d+)/norm_ff/scale",
     "encoder.{0}_blocks.{1}.norm2.weight", "none"),
    (r"encoder/(temporal|spectral)_(\d+)/ff/(wi|wo)/kernel",
     "encoder.{0}_blocks.{1}.mlp.{2}.weight", "t"),
    (r"projection/group_proj/kernel", "projection.group_proj.weight", "t"),
]

INVERSE_RULES = T5_INVERSE_RULES + PERCEIVER_INVERSE_RULES


def _transform(arr: np.ndarray, tf: str) -> np.ndarray:
    if tf == "t" and arr.ndim == 2:
        return arr.T
    if tf == "conv":
        return arr.transpose(3, 2, 0, 1)
    return arr


def flatten_params(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Nested param tree (or `/`-joined flat paths) → {path: array},
    without the 'params' root."""
    flat: Dict[str, np.ndarray] = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else k
            if isinstance(v, Mapping):
                walk(v, p)
            else:
                flat[p] = np.asarray(v)

    walk(params)
    return {re.sub(r"^params/", "", p): a for p, a in flat.items()}


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX param tree (numpy arrays) → the port's state_dict.

    Raises on any param no rule maps, so the port and the reference can
    never drift apart silently. The derived `qweights` collection is not
    a param and is skipped."""
    out: Dict[str, torch.Tensor] = {}
    missing: List[str] = []
    for path, arr in flatten_params(params).items():
        if path.startswith("qweights/"):
            continue
        for pat, tmpl, tf in INVERSE_RULES:
            m = re.fullmatch(pat, path)
            if m:
                out[tmpl.format(*m.groups())] = torch.from_numpy(
                    np.array(_transform(arr, tf), dtype=np.float32, order="C"))
                break
        else:
            missing.append(path)
    if missing:
        raise ValueError(f"no T5 rule (nor a Perceiver-TF or projection rule) "
                         f"for params: {missing}")
    return out
