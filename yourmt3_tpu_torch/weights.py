"""Weights from the JAX package's param tree into the port's modules.

The port names its parameters after the reference checkpoint naming
(HF T5 style), which is what the JAX package's importer reads and its
`reference_style_state_dict` writes. `state_dict_from_jax` applies its
inverse import rules for the T5 family, the Perceiver-TF encoder (dense
or mixture-of-experts FF), the conformer and every projection (flax path
→ torch name, with flax (in, out) kernels transposed to torch's
(out, in), (kh, kw, in, out) conv kernels to (out, in, kh, kw) and
(k, 1, ch) depthwise kernels to (ch, 1, k); the stacked expert tensors
keep their orientation), so its result loads into `models.ymt3.YMT3`
with `load_state_dict(strict=True)`. The T5 rules come first, as in the
reference, so the conformer's input projection and bias table take the
T5 encoder's names. The reference has no naming for a T5 layer's
mixture-of-experts FF (ff_act="moe"); the port names its router and
experts under the layer's `DenseReluDense`. JAX's derived `qweights`
collection (the decode-time quantized decoder weights) is skipped: the
port derives its own from the fp32 master.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

# flax path regex → (torch name template, transform); "t" = transpose 2-D,
# "conv" = flax (kh, kw, in, out) → torch (out, in, kh, kw), "dwconv" =
# flax depthwise (k, 1, ch) → torch (ch, 1, k)
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

# ff_act="moe" in the T5 layers: port-side names (the reference has none)
T5_MOE_INVERSE_RULES: List[Tuple[str, str, str]] = [
    (r"encoder/layer_(\d+)/ff/router/kernel",
     "encoder.block.{0}.layer.1.DenseReluDense.router.weight", "t"),
    (r"encoder/layer_(\d+)/ff/(wi|wo)",
     "encoder.block.{0}.layer.1.DenseReluDense.experts_{1}", "none"),
    (r"decoder/(?:decoder/)?layer_(\d+)/ff/router/kernel",
     "decoder.block.{0}.layer.2.DenseReluDense.router.weight", "t"),
    (r"decoder/(?:decoder/)?layer_(\d+)/ff/(wi|wo)",
     "decoder.block.{0}.layer.2.DenseReluDense.experts_{1}", "none"),
]

# Perceiver-TF encoder (dense or mixture-of-experts FF); its final norm is
# `encoder/final_norm`, which the T5 rule above maps first
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
    (r"encoder/(temporal|spectral)_(\d+)/ff/router/kernel",
     "encoder.{0}_blocks.{1}.mlp.router.weight", "t"),
    (r"encoder/(temporal|spectral)_(\d+)/ff/(wi|wo)",
     "encoder.{0}_blocks.{1}.mlp.experts_{2}", "none"),
]

PROJECTION_INVERSE_RULES: List[Tuple[str, str, str]] = [
    (r"projection/group_proj/kernel", "projection.group_proj.weight", "t"),
    (r"projection/(proj|proj_in|proj_out|pw_proj)/kernel",
     "projection.{0}.weight", "t"),
    (r"projection/(dw_conv|group_dw_conv)/kernel",
     "projection.{0}.weight", "dwconv"),
]

# conformer blocks; its input_proj and rel_bias take the T5 rules above
CONFORMER_INVERSE_RULES: List[Tuple[str, str, str]] = [
    (r"encoder/block_(\d+)/(ffn1|ffn2)/RMSNorm_0/scale",
     "encoder.conformer.{0}.{1}.norm.weight", "none"),
    (r"encoder/block_(\d+)/(ffn1|ffn2)/(wi|wo)/kernel",
     "encoder.conformer.{0}.{1}.{2}.weight", "t"),
    (r"encoder/block_(\d+)/attn_norm/scale",
     "encoder.conformer.{0}.attn_norm.weight", "none"),
    (r"encoder/block_(\d+)/attn/([qkvo])/kernel",
     "encoder.conformer.{0}.attention.{1}.weight", "t"),
    (r"encoder/block_(\d+)/conv/RMSNorm_0/scale",
     "encoder.conformer.{0}.conv.norm.weight", "none"),
    (r"encoder/block_(\d+)/conv/(pointwise_in|pointwise_out)/kernel",
     "encoder.conformer.{0}.conv.{1}.weight", "t"),
    (r"encoder/block_(\d+)/conv/depthwise/kernel",
     "encoder.conformer.{0}.conv.depthwise.weight", "dwconv"),
    (r"encoder/block_(\d+)/conv/conv_norm/scale",
     "encoder.conformer.{0}.conv.conv_norm.weight", "none"),
    (r"encoder/block_(\d+)/final_norm/scale",
     "encoder.conformer.{0}.final_norm.weight", "none"),
]

INVERSE_RULES = (T5_INVERSE_RULES + T5_MOE_INVERSE_RULES
                 + PERCEIVER_INVERSE_RULES + PROJECTION_INVERSE_RULES
                 + CONFORMER_INVERSE_RULES)


def _transform(arr: np.ndarray, tf: str) -> np.ndarray:
    if tf == "t" and arr.ndim == 2:
        return arr.T
    if tf == "conv":
        return arr.transpose(3, 2, 0, 1)
    if tf == "dwconv":
        return arr.transpose(2, 1, 0)
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
        raise ValueError(f"no T5 rule (nor a Perceiver-TF, conformer or "
                         f"projection rule) for params: {missing}")
    return out
