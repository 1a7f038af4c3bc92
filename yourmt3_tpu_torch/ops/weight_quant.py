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

`int8_linear` computes an int8 layer's product: the hand-written kernel
(`csrc/int8_linear.cu`) for CUDA tensors, `int8_linear_plain` for CPU
tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils import profiling
from . import cuda_build

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


def int8_linear_plain(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """x (M, K) · w_q (N, K)ᵀ scaled per output channel, the reference's
    staging: the product in x's dtype on the weight cast to it (int8
    values are exact in bf16), rounded to x's dtype, then scaled in fp32
    and rounded again."""
    y = F.linear(x, w_q.to(x.dtype))
    return (y.to(torch.float32) * scale).to(x.dtype)


_op = None  # torch.ops.yourmt3_tpu_torch.int8_linear, bound at first use


def int8_linear(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """`int8_linear_plain(x, w_q, scale)`: x (M, K) fp32 or bf16, w_q (N, K)
    int8, scale (N,) fp32 → (M, N) in x's dtype.

    CPU tensors go to the plain version. CUDA tensors launch the
    hand-written kernel (`csrc/int8_linear.cu`, the operator
    `torch.ops.yourmt3_tpu_torch.int8_linear`), which reads the int8
    weight itself, allocates only the output and counts one launch, or
    raise. It takes x dense in its last dimension with any row stride that
    keeps each row on a 16-byte boundary, and K a multiple of 16. Nothing
    falls back from one to the other."""
    if (x.dim() != 2 or w_q.dim() != 2 or w_q.shape[1] != x.shape[1]
            or tuple(scale.shape) != (w_q.shape[0],)):
        raise ValueError(f"int8_linear takes x (M, K), w_q (N, K) and scale (N,), got "
                         f"{tuple(x.shape)}, {tuple(w_q.shape)}, {tuple(scale.shape)}")
    if (x.dtype not in (torch.float32, torch.bfloat16) or w_q.dtype != torch.int8
            or scale.dtype != torch.float32):
        raise TypeError(f"int8_linear takes x fp32 or bf16, w_q int8 and scale fp32, got "
                        f"{x.dtype}, {w_q.dtype}, {scale.dtype}")
    if not x.device == w_q.device == scale.device:
        raise ValueError(f"x, w_q and scale are on {x.device}, {w_q.device}, "
                         f"{scale.device}")
    if x.is_cpu:
        return int8_linear_plain(x, w_q, scale)
    global _op
    if _op is None:
        _op = cuda_build.op("int8_linear")
    out = _op(x, w_q, scale)
    int8_linear.launches += 1
    return out


int8_linear.launches = 0  # kernel launches since the last reset
profiling.register_kernel("int8_linear", int8_linear)
