"""Seeded weights, drawn on the device, for the model under test and for
the reference alike.

The tensors are filled by name and shape, in sorted name order, from one
normal draw of their total size on a torch.Generator of the target
device: norms are ones, biases zeros, the token embedding N(0, 1), the
position and bias tables and the latents N(0, 0.02), every other weight
N(0, 1/fan_in), experts over the expert axis too and the attention
queries with T5's 1/d_kv folded in. A configuration may zero rows: the
LM head's EOS row, so that random weights never end a stream and every
seed decodes the same number of steps. The draw depends only on the seed and
the table of names and shapes, so both sides get the same tensors.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

SMALL = ("relative_attention_bias", "pos_emb", "latent_array")


def weight_seed(seed: int) -> int:
    """The weights' own stream, apart from the traffic's and the masks'."""
    return int(np.random.SeedSequence([seed, 7]).generate_state(1, np.uint64)[0]) >> 1


def init_std(name: str, shape: Tuple[int, ...], q_dkv: Dict[str, int]):
    """→ "ones", "zeros" or the standard deviation of `name`'s normal."""
    module = name.split(".")[-2] if "." in name else ""
    if "norm" in module and len(shape) == 1:
        return "ones"
    if name.endswith(".bias"):
        return "zeros"
    if name == "shared.weight":
        return 1.0
    if any(s in name for s in SMALL):
        return 0.02
    if "experts_" in name:
        return math.sqrt(1.0 / (shape[0] * shape[1]))
    std = math.sqrt(1.0 / math.prod(shape[1:]))
    if name.endswith(".q.weight"):
        std /= math.sqrt(q_dkv["decoder" if name.startswith("decoder.") else "encoder"])
    return std


def generate(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
             q_dkv: Dict[str, int],
             zero_rows: Optional[Dict[str, List[int]]] = None) -> Dict[str, torch.Tensor]:
    """name → float32 tensor on `device`, from one draw of the total size;
    `zero_rows` names rows set to zero afterwards (name → row indices)."""
    names = sorted(shapes)
    total = sum(math.prod(shapes[n]) for n in names)
    gen = torch.Generator(device=device).manual_seed(weight_seed(seed))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for n in names:
        size = math.prod(shapes[n])
        t = flat[at: at + size].view(shapes[n])
        at += size
        std = init_std(n, shapes[n], q_dkv)
        if std == "ones":
            t.fill_(1.0)
        elif std == "zeros":
            t.zero_()
        else:
            t.mul_(std)
        out[n] = t
    for n, rows in (zero_rows or {}).items():
        out[n][rows] = 0.0
    return out


def for_config(config: dict, shapes: Dict[str, Tuple[int, ...]], seed: int,
               device, model: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """The weights of a configuration file: its query head widths (the
    decoder's d_kv, the encoder module's `query_width`) and its zeroed rows."""
    from reference.model import encoder_of
    model = model or config["model"]
    widths = {"decoder": model["d_kv"], "encoder": encoder_of(config).query_width(model)}
    return generate(shapes, seed, device, widths, config.get("init", {}).get("zero_rows"))
