"""Quantized decoder weights for decode (`ModelConfig.weight_quant`).

Every bias-free linear layer of the decoder, the LM head included, can
carry a side-car copy of its weight that the decode reads instead of the
fp32 master:

  - "bf16": the weight rounded to bfloat16;
  - "int8": int8 values with one fp32 scale per output channel
    (symmetric: scale = max(max|w| over the inputs, 1e-12) / 127,
    q = clip(round-half-even(w / scale), -127, 127)); the scale applies
    to the product's output.

The side-cars are non-persistent buffers of `models.layers.QuantDense`,
derived from the fp32 master whenever it is set (random init or
`load_state_dict`), so checkpoints and state dicts hold only the master.
The encoder and the encoder→decoder projection keep their fp32 weights.
"""

from __future__ import annotations

from typing import Tuple

import torch

MODES = ("none", "bf16", "int8")


def quantize_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) fp32 weight → ((out, in) int8, (out,) fp32 scales)."""
    w = w.detach().to(torch.float32)
    # divisors as 0-dim fp32 tensors: true fp32 divisions on every device
    scale = torch.clamp(torch.amax(torch.abs(w), dim=1), min=1e-12) / torch.full(
        (), 127.0, dtype=torch.float32, device=w.device)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def quantize_decoder_weights(model: torch.nn.Module, mode: str) -> None:
    """Attach `mode` side-cars to every QuantDense of `model.decoder` and
    to `model.lm_head` (a YMT3); "none" removes them."""
    from ..models.layers import QuantDense
    if mode not in MODES:
        raise ValueError(f"weight_quant mode must be one of {MODES}, got "
                         f"{mode!r}")
    layers = [m for m in model.decoder.modules() if isinstance(m, QuantDense)]
    layers.append(model.lm_head)
    for lin in layers:
        lin.set_weight_quant(mode)
