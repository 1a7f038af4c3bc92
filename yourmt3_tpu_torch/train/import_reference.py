"""Reference-checkpoint importer: a PyTorch `.ckpt` of the reference
(YourMT3's Lightning checkpoint) → the port's model.

The port's own copy of what it needs from the JAX package's
`train/import_torch.py`. The reference stores a Lightning checkpoint whose
`state_dict` uses (modified-)HF T5 naming; the port names its parameters
after that naming and keeps torch's (out, in) layout, so most names map
to themselves and no tensor is transposed. What the rules below do:
- strip the prefixes `model.`, `module.`, `ymt3.`, `net.` (each at most
  once, in that order, as the JAX importer does);
- stack per-expert `<base>.experts.{e}.wi|wo.weight` linear weights
  ((ff, d) / (d, ff)) into the port's `<base>.experts_wi` (E, d, ff) and
  `<base>.experts_wo` (E, ff, d);
- accept every name the JAX importer's ALL_RULES accepts, and where those
  rules allow alternatives (`encoder.latents`, `encoder.time_pos_emb`,
  `decoder.embed_tokens.weight`, `pre_decoder.*`, the conformer's
  `encoder.input_proj`/`encoder.rel_bias`, ...) map them onto the port's
  one name.
Unmatched source keys are reported, never silently dropped; a matched key
whose parameter the model lacks is skipped, as in the JAX importer.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch

STRIP_PREFIXES = ("model.", "module.", "ymt3.", "net.")

# (regex on the reference name, the port's name); first match wins
RULES: List[Tuple[str, str]] = [
    # T5 encoder
    (r"encoder\.block\.(\d+)\.layer\.0\.SelfAttention\.([qkvo])\.weight",
     "encoder.block.{0}.layer.0.SelfAttention.{1}.weight"),
    (r"encoder\.block\.(\d+)\.layer\.0\.layer_norm\.weight",
     "encoder.block.{0}.layer.0.layer_norm.weight"),
    (r"encoder\.block\.(\d+)\.layer\.1\.DenseReluDense\.(wi_0|wi_1|wi|wo)\.weight",
     "encoder.block.{0}.layer.1.DenseReluDense.{1}.weight"),
    (r"encoder\.block\.(\d+)\.layer\.1\.layer_norm\.weight",
     "encoder.block.{0}.layer.1.layer_norm.weight"),
    (r"encoder\.block\.0\.layer\.0\.SelfAttention\.relative_attention_bias\.weight",
     "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
    (r"encoder\.final_layer_norm\.weight", "encoder.final_layer_norm.weight"),
    (r"encoder\.proj\.weight", "encoder.proj.weight"),
    # T5 decoder
    (r"decoder\.block\.(\d+)\.layer\.0\.SelfAttention\.([qkvo])\.weight",
     "decoder.block.{0}.layer.0.SelfAttention.{1}.weight"),
    (r"decoder\.block\.(\d+)\.layer\.0\.layer_norm\.weight",
     "decoder.block.{0}.layer.0.layer_norm.weight"),
    (r"decoder\.block\.(\d+)\.layer\.1\.EncDecAttention\.([qkvo])\.weight",
     "decoder.block.{0}.layer.1.EncDecAttention.{1}.weight"),
    (r"decoder\.block\.(\d+)\.layer\.1\.layer_norm\.weight",
     "decoder.block.{0}.layer.1.layer_norm.weight"),
    (r"decoder\.block\.(\d+)\.layer\.2\.DenseReluDense\.(wi_0|wi_1|wi|wo)\.weight",
     "decoder.block.{0}.layer.2.DenseReluDense.{1}.weight"),
    (r"decoder\.block\.(\d+)\.layer\.2\.layer_norm\.weight",
     "decoder.block.{0}.layer.2.layer_norm.weight"),
    (r"decoder\.block\.0\.layer\.0\.SelfAttention\.relative_attention_bias\.weight",
     "decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
    (r"decoder\.final_layer_norm\.weight", "decoder.final_layer_norm.weight"),
    (r"(?:shared|decoder\.embed_tokens|embed_tokens)\.weight", "shared.weight"),
    (r"lm_head\.weight", "lm_head.weight"),
    # Perceiver-TF encoder
    (r"encoder\.latent(?:s|_array)?(?:\.weight)?", "encoder.latent_array"),
    (r"encoder\.(?:pos_emb|time_pos_emb)(?:\.weight)?", "encoder.pos_emb"),
    (r"encoder\.pre_encoder\.block\.(\d+)\.(conv_down|conv_a|conv_b)\.(weight|bias)",
     "encoder.pre_encoder.block.{0}.{1}.{2}"),
    (r"encoder\.spectral_proj\.weight", "encoder.spectral_proj.weight"),
    (r"encoder\.sca\.(norm_q|norm_kv|ff_norm)\.weight", "encoder.sca.{0}.weight"),
    (r"encoder\.sca\.attention\.([qkvo])\.weight", "encoder.sca.attention.{0}.weight"),
    (r"encoder\.sca\.ff\.(wi|wo)\.weight", "encoder.sca.ff.{0}.weight"),
    (r"encoder\.(temporal|spectral)_blocks\.(\d+)\.(norm1|norm2)\.weight",
     "encoder.{0}_blocks.{1}.{2}.weight"),
    (r"encoder\.(temporal|spectral)_blocks\.(\d+)\.attention\.([qkvo])\.weight",
     "encoder.{0}_blocks.{1}.attention.{2}.weight"),
    (r"encoder\.(temporal|spectral)_blocks\.(\d+)\.mlp\.(wi|wo|router)\.weight",
     "encoder.{0}_blocks.{1}.mlp.{2}.weight"),
    (r"encoder\.(temporal|spectral)_blocks\.(\d+)\.mlp\.experts_(wi|wo)",
     "encoder.{0}_blocks.{1}.mlp.experts_{2}"),
    (r"encoder\.(?:final_norm|layernorm)\.weight", "encoder.final_layer_norm.weight"),
    # encoder → decoder projection
    (r"(?:projection|pre_decoder)\.(group_proj|proj|proj_in|proj_out|dw_conv|pw_proj"
     r"|group_dw_conv)\.weight", "projection.{0}.weight"),
    # conformer
    (r"encoder\.input_proj\.weight", "encoder.proj.weight"),
    (r"encoder\.rel_bias\.weight",
     "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
    (r"encoder\.conformer\.(\d+)\.(ffn1|ffn2)\.norm\.weight",
     "encoder.conformer.{0}.{1}.norm.weight"),
    (r"encoder\.conformer\.(\d+)\.(ffn1|ffn2)\.(wi|wo)\.weight",
     "encoder.conformer.{0}.{1}.{2}.weight"),
    (r"encoder\.conformer\.(\d+)\.(attn_norm|final_norm)\.weight",
     "encoder.conformer.{0}.{1}.weight"),
    (r"encoder\.conformer\.(\d+)\.attention\.([qkvo])\.weight",
     "encoder.conformer.{0}.attention.{1}.weight"),
    (r"encoder\.conformer\.(\d+)\.conv\.(norm|pointwise_in|pointwise_out|depthwise"
     r"|conv_norm)\.weight", "encoder.conformer.{0}.conv.{1}.weight"),
    # learned absolute encoder positions (encoder_abs_pos="learned")
    (r"encoder\.pos_embed(?:\.weight)?", "encoder.pos_embed"),
]


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file → {name: fp32 CPU tensor}: Lightning's
    {"state_dict": ...} is unwrapped, a bare state dict taken as it is,
    and entries that are not tensors are dropped.

    The file is read with `torch.load(weights_only=True)`, which takes
    tensors, numbers, strings and containers of them. A Lightning file
    whose `hyper_parameters`, callback or loop states hold other Python
    objects does not load that way: it needs `weights_only=False`, which
    runs the file's pickled code, so do that only for a file you trust,
    or first re-save its `state_dict` alone."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: v.detach().to(torch.float32) for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def _stack_expert_tensors(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-expert `<base>.experts.{e}.wi|wo.weight` linear weights → the
    stacked `<base>.experts_wi` (E, d, ff) / `<base>.experts_wo` (E, ff, d)."""
    groups: Dict[Tuple[str, str], Dict[int, torch.Tensor]] = {}
    rest: Dict[str, torch.Tensor] = {}
    pat = re.compile(r"(.*)\.experts\.(\d+)\.(wi|wo)\.weight$")
    for k, v in sd.items():
        m = pat.match(k)
        if m:
            groups.setdefault((m.group(1), m.group(3)), {})[int(m.group(2))] = v
        else:
            rest[k] = v
    for (base, which), by_idx in groups.items():
        rest[f"{base}.experts_{which}"] = torch.stack(
            [by_idx[i].T for i in sorted(by_idx)])
    return rest


def map_state_dict(sd: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A reference state dict → ({port name: tensor}, unmatched source
    names)."""
    mapped: Dict[str, torch.Tensor] = {}
    unmatched: List[str] = []
    for name, t in _stack_expert_tensors(sd).items():
        n = name
        for p in STRIP_PREFIXES:
            if n.startswith(p):
                n = n[len(p):]
        for pat, tmpl in RULES:
            m = re.fullmatch(pat, n)
            if m:
                mapped[tmpl.format(*m.groups())] = t
                break
        else:
            unmatched.append(name)
    return mapped, unmatched


def import_state_dict(sd: Dict[str, torch.Tensor], model: torch.nn.Module,
                      verbose: bool = True, require_complete: bool = False):
    """Load a reference state dict into `model` in place (the decoder's
    quantized side-car weights are rebuilt from the loaded masters).
    Raises ValueError on a shape that differs from the model's and, with
    require_complete, when a source key matched no rule or a parameter of
    the model received no tensor. → the model."""
    mapped, unmatched = map_state_dict(sd)
    target = model.state_dict()
    applied = []
    for name, t in mapped.items():
        if name not in target:
            continue
        if target[name].shape != t.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} vs expected "
                             f"{tuple(target[name].shape)}")
        target[name] = t.to(target[name].dtype)
        applied.append(name)
    if verbose:
        print(f"imported {len(applied)}/{len(mapped)} mapped tensors; "
              f"{len(unmatched)} source keys unmatched")
        for u in unmatched[:20]:
            print("  unmatched:", u)
    if require_complete:
        missing = sorted(set(target) - set(applied))
        if unmatched or missing:
            raise ValueError(
                f"incomplete import: {len(unmatched)} source keys unmatched "
                f"({unmatched[:5]}...), {len(missing)} target params not "
                f"applied ({missing[:5]}...)")
    model.load_state_dict(target, strict=True)
    return model


def import_checkpoint(ckpt_path: str, model: torch.nn.Module, verbose: bool = True,
                      require_complete: bool = False):
    """A reference checkpoint file → its weights in `model` (in place);
    require_complete=True raises unless every parameter received a tensor
    and every source key matched. → the model."""
    return import_state_dict(load_torch_state_dict(ckpt_path), model,
                             verbose=verbose, require_complete=require_complete)


def reference_style_state_dict(model: torch.nn.Module,
                               per_expert: bool = False) -> Dict[str, torch.Tensor]:
    """The inverse of `map_state_dict`: `model`'s weights under the
    reference's names, as a Lightning checkpoint's `state_dict` carries
    them (each under `model.`; per_expert=True writes each expert's
    `experts.{e}.wi|wo.weight` linear weight instead of the stacked
    tensors). Every name maps back through RULES, or this raises."""
    out: Dict[str, torch.Tensor] = {}
    for name, t in model.state_dict().items():
        t = t.detach().to("cpu", torch.float32)
        m = re.fullmatch(r"(.*)\.experts_(wi|wo)", name)
        if per_expert and m:
            for e in range(t.shape[0]):
                out[f"model.{m.group(1)}.experts.{e}.{m.group(2)}.weight"] = (
                    t[e].T.contiguous())
        else:
            out["model." + name] = t.clone()
    mapped, unmatched = map_state_dict(out)
    lost = unmatched or sorted(set(model.state_dict()) - set(mapped))
    if lost:
        raise ValueError(f"no reference name for: {lost}")
    return out
