"""Shared transformer building blocks (T5.1.1 semantics).

Conventions held against the JAX reference:
- params fp32, activations in the compute dtype, norms and softmax in fp32;
- attention logits and the probabilities·V product accumulate and stay in
  fp32 where the reference asks for `preferred_element_type=float32`, so
  bf16 operands are upcast before those products;
- no 1/sqrt(d) attention scale (T5 folds it into the query init);
- masks are additive -1e9 biases.

Parameter names follow the reference checkpoint naming (HF T5 style), so
`weights.state_dict_from_jax` loads with `strict=True`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ---------------------------------------------------------------------------
# Initialisers (distributions of the reference's flax initialisers)
# ---------------------------------------------------------------------------

def normal_(w: torch.Tensor, std: float, gen: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return w.normal_(0.0, std, generator=gen)


def fan_in_normal_(w: torch.Tensor, gen: torch.Generator,
                   scale: float = 1.0) -> torch.Tensor:
    """variance_scaling(scale, "fan_in", "normal") on a (out, in) weight."""
    return normal_(w, math.sqrt(scale / w.shape[1]), gen)


def lecun_truncated_normal_(w: torch.Tensor,
                            gen: torch.Generator) -> torch.Tensor:
    """lecun_normal: truncated at ±2σ with σ corrected for the cut; the
    fan-in of an (out, in, ...) weight is everything but its first axis."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=gen)


# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """T5-style RMSNorm: no bias, no mean subtraction, fp32 accumulation."""

    def __init__(self, dim: int, dtype: torch.dtype, eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.eps = eps
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.weight).to(self.dtype)


def relative_position_bucket(relative_position: torch.Tensor,
                             bidirectional: bool,
                             num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """T5 relative-position bucketing, in fp32 as the reference computes it
    (the `+1e-6` inside the log is part of the bucket boundaries)."""
    ret = torch.zeros_like(relative_position)
    n = -relative_position
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(relative_position.dtype) * num_buckets
        n = torch.abs(n)
    else:
        n = torch.clamp(n, min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    # True fp32 divisions, as in the reference: the divisors are 0-dim
    # tensors on n's device, because CUDA divides by a Python scalar as a
    # multiply by its reciprocal, which can move a bucket boundary.
    def f32(x):
        return torch.full((), x, dtype=torch.float32, device=n.device)

    log_ratio = f32(np.float32(np.log(max_distance / max_exact)))
    val_if_large = max_exact + (
        torch.log(n.to(torch.float32) / f32(max_exact) + 1e-6)
        / log_ratio * (num_buckets - max_exact)
    ).to(relative_position.dtype)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def distance_buckets(num_buckets: int, max_distance: int,
                     device=None) -> torch.Tensor:
    """(max_distance + 1,) int32 decoder bucket of each query-minus-key
    distance d; every larger distance lands in the last bucket. The paged
    decode kernel gathers from this instead of re-deriving the log-spaced
    boundaries, so its bias equals the dense path's bit for bit."""
    d = torch.arange(max_distance + 1, dtype=torch.int32, device=device)
    return relative_position_bucket(-d, False, num_buckets, max_distance)


class RelativePositionBias(nn.Module):
    """Bucketed relative attention bias table (buckets, H), owned by the
    first layer's self-attention as in the reference naming."""

    def __init__(self, num_heads: int, num_buckets: int = 32,
                 max_distance: int = 128, bidirectional: bool = True,
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(num_buckets, num_heads, device=device))
        self.num_buckets = num_buckets
        self.max_distance = max_distance
        self.bidirectional = bidirectional
        self.dtype = dtype
        if not bidirectional:  # the decoder's table for the paged kernel
            self.register_buffer(
                "distance_buckets",
                distance_buckets(num_buckets, max_distance, device),
                persistent=False)

    def buckets(self, q_len: int, k_len: int, device) -> torch.Tensor:
        ctx = torch.arange(q_len, device=device, dtype=torch.int32)[:, None]
        mem = torch.arange(k_len, device=device, dtype=torch.int32)[None, :]
        return relative_position_bucket(mem - ctx, self.bidirectional,
                                        self.num_buckets, self.max_distance)

    def forward(self, q_len: int, k_len: int) -> torch.Tensor:
        """→ (1, H, q_len, k_len) additive bias in the module's dtype."""
        bias = self.weight[self.buckets(q_len, k_len, self.weight.device).long()]
        return bias.permute(2, 0, 1)[None].to(self.dtype)


class QuantDense(nn.Module):
    """Bias-free linear layer in the compute dtype: x and the fp32 master
    weight are cast to `dtype` before the product (the reference's
    promote-then-dot).

    With a weight_quant mode set (ops/weight_quant.py) it reads the
    side-car `weight_q` instead: bf16, or int8 with per-output-channel
    `weight_scale`. The int8 product is rounded to `dtype`, then scaled in
    fp32 and rounded again, as the reference does. The side-cars are
    non-persistent buffers recomputed from the master whenever a state
    dict is loaded (`reset_parameters` callers call `requantize`)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, device=device))
        self.dtype = dtype
        self.weight_quant = "none"

    def set_weight_quant(self, mode: str) -> None:
        self.weight_quant = mode
        self.requantize()

    @torch.no_grad()
    def requantize(self) -> None:
        from ..ops.weight_quant import quantize_int8
        for name in ("weight_q", "weight_scale"):
            if name in self._buffers:
                del self._buffers[name]
        if self.weight_quant == "bf16":
            self.register_buffer("weight_q", self.weight.to(torch.bfloat16),
                                 persistent=False)
        elif self.weight_quant == "int8":
            q, scale = quantize_int8(self.weight)
            self.register_buffer("weight_q", q, persistent=False)
            self.register_buffer("weight_scale", scale, persistent=False)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        if self.weight_quant != "none":
            self.requantize()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight_quant == "none":
            return F.linear(x.to(self.dtype), self.weight.to(self.dtype))
        y = F.linear(x.to(self.dtype), self.weight_q.to(self.dtype))
        if self.weight_quant == "int8":
            y = (y.to(torch.float32) * self.weight_scale).to(self.dtype)
        return y


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,H,Tq,D),(B,H,Tk,D),(B,H,Tk,Dv)[,(·,H,Tq,Tk)] → (B,H,Tq,Dv).

    No 1/sqrt(d) scale; logits and the output product in fp32."""
    logits = torch.matmul(q.to(torch.float32),
                          k.to(torch.float32).transpose(-1, -2))
    if bias is not None:
        logits = logits + bias.to(torch.float32)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs.to(torch.float32), v.to(torch.float32))
    return out.to(v.dtype)


class MultiHeadAttention(nn.Module):
    """T5-style MHA with head-folded (H·dk, d_model) projections."""

    def __init__(self, num_heads: int, d_kv: int, d_model: int,
                 dtype: torch.dtype, num_kv_heads: Optional[int] = None,
                 relative_bias: Optional[RelativePositionBias] = None,
                 device=None, use_rope: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.kv_heads = num_kv_heads or num_heads
        self.d_kv = d_kv
        self.use_rope = use_rope  # rotary q/k over the sequence axis
        self.q = QuantDense(d_model, num_heads * d_kv, dtype, device)
        self.k = QuantDense(d_model, self.kv_heads * d_kv, dtype, device)
        self.v = QuantDense(d_model, self.kv_heads * d_kv, dtype, device)
        self.o = QuantDense(num_heads * d_kv, d_model, dtype, device)
        if relative_bias is not None:
            self.relative_attention_bias = relative_bias

    def reset_parameters(self, gen: torch.Generator) -> None:
        # the 1/sqrt(d_kv) logit scale lives in the query init
        fan_in_normal_(self.q.weight, gen, 1.0 / self.d_kv)
        for lin in (self.k, self.v, self.o):
            fan_in_normal_(lin.weight, gen)

    def split(self, x: torch.Tensor, heads: int) -> torch.Tensor:
        b, t, _ = x.shape
        return x.reshape(b, t, heads, self.d_kv).transpose(1, 2)

    @staticmethod
    def merge(x: torch.Tensor) -> torch.Tensor:
        b, h, t, d = x.shape
        return x.transpose(1, 2).reshape(b, t, h * d)

    def group_queries(self, q: torch.Tensor) -> torch.Tensor:
        """(B, H, T, dk) → (B, Hkv, G·T, dk)."""
        b, h, t, d = q.shape
        return q.reshape(b, self.kv_heads, (h // self.kv_heads) * t, d)

    def ungroup_heads(self, x: torch.Tensor, t: int) -> torch.Tensor:
        return x.reshape(x.shape[0], self.num_heads, t, x.shape[-1])

    def group_bias(self, bias: Optional[torch.Tensor],
                   t: int) -> Optional[torch.Tensor]:
        if bias is None:
            return None
        if bias.shape[1] == 1:
            bias = bias.expand(bias.shape[0], self.num_heads, *bias.shape[2:])
        g = self.num_heads // self.kv_heads
        return bias.reshape(bias.shape[0], self.kv_heads, g * t, bias.shape[-1])

    def project_kv(self, x_kv: torch.Tensor):
        return (self.split(self.k(x_kv), self.kv_heads),
                self.split(self.v(x_kv), self.kv_heads))

    def forward(self, x_q: torch.Tensor, x_kv: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        q = self.split(self.q(x_q), self.num_heads)
        k, v = self.project_kv(x_kv)
        if self.use_rope:
            q, k = rope_rotate(q), rope_rotate(k)
        if self.kv_heads != self.num_heads:
            t = q.shape[2]
            out = dot_product_attention(self.group_queries(q), k, v,
                                        self.group_bias(bias, t))
            out = self.ungroup_heads(out, t)
        else:
            out = dot_product_attention(q, k, v, bias)
        return self.o(self.merge(out))


def rope_rotate(x: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding over the sequence axis: (B, H, T, dk),
    dk even → same shape. Head-dim element i pairs with i + dk/2, and the
    pair turns by angle t / base^(i / (dk/2)); angles and the rotation in
    fp32, the result in x's dtype."""
    T, dk = x.shape[-2], x.shape[-1]
    half = dk // 2
    f32 = dict(dtype=torch.float32, device=x.device)
    # true fp32 divisions, as eager JAX computes them (see
    # relative_position_bucket)
    expo = torch.arange(half, **f32) / torch.full((), half, **f32)
    freqs = 1.0 / torch.pow(torch.full((), base, **f32), expo)
    ang = torch.arange(T, **f32)[:, None] * freqs[None]  # (T, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def alibi_slopes(num_heads: int) -> np.ndarray:
    """ALiBi per-head slopes: the geometric sequence 2^(-8h/H), h = 1..H."""
    start = 2.0 ** (-8.0 / num_heads)
    return start ** np.arange(1, num_heads + 1)


def alibi_bias(num_heads: int, q_len: int, k_len: int,
               device=None) -> torch.Tensor:
    """(1, H, q_len, k_len) fp32 additive bias -slope_h·|i - j| (the
    bidirectional form: the encoder attends both ways)."""
    slopes = torch.tensor(alibi_slopes(num_heads).astype(np.float32),
                          device=device)
    dist = torch.abs(torch.arange(k_len, device=device)[None, :]
                     - torch.arange(q_len, device=device)[:, None])
    return (-slopes[:, None, None] * dist[None].to(torch.float32))[None]


ACTIVATIONS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu default
    "silu": F.silu,
}


class Dropout(nn.Module):
    """Dropout with flax semantics, driven by an explicit generator.

    In train() mode each element is kept with probability 1 - rate and
    scaled by 1 / (1 - rate); in eval() mode (the reference's
    `deterministic=True`), or at rate 0, it is the identity. `generator`
    is a torch.Generator on the activations' device, set for the whole
    model by `YMT3.set_dropout_generator`; None draws from the device's
    default generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        if keep == 0.0:
            return torch.zeros_like(x)
        mask = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


class FeedForward(nn.Module):
    """T5.1.1 gated FF (act(wi_0) ⊙ wi_1 → wo) or plain act FF, with
    dropout on the hidden activations before `wo`."""

    def __init__(self, d_model: int, d_ff: int, act: str,
                 dtype: torch.dtype, device=None, dropout_rate: float = 0.0):
        super().__init__()
        self.gated = act.startswith("gated-")
        self.act = ACTIVATIONS[act.split("-")[1] if self.gated else act]
        if self.gated:
            self.wi_0 = QuantDense(d_model, d_ff, dtype, device)
            self.wi_1 = QuantDense(d_model, d_ff, dtype, device)
        else:
            self.wi = QuantDense(d_model, d_ff, dtype, device)
        self.wo = QuantDense(d_ff, d_model, dtype, device)
        self.dropout = Dropout(dropout_rate)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for lin in self.children():
            if isinstance(lin, QuantDense):
                fan_in_normal_(lin.weight, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.gated:
            y = self.act(self.wi_0(x)) * self.wi_1(x)
        else:
            y = self.act(self.wi(x))
        return self.wo(self.dropout(y))


class MoEFeedForward(nn.Module):
    """Token-choice top-k mixture-of-experts FF, computed densely as the
    reference does: every expert runs on every token in fp32 and a sparse
    gate weighs the results.

    The router is a bias-free fp32 linear layer on x in fp32; softmax over
    the experts, top-k, the top-k probabilities scattered back over the
    experts and renormalised (sum + 1e-9). The experts are stacked fp32
    tensors in the reference's orientation, `experts_wi` (E, d, ff) and
    `experts_wo` (E, ff, d), with `act` between them; the gated sum is
    cast to the compute dtype. No dropout. The weights are plain
    parameters, not `QuantDense`, so decoder weight quantization leaves
    them in fp32, as in the reference."""

    def __init__(self, num_experts: int, d_model: int, d_ff: int,
                 dtype: torch.dtype, top_k: int = 2, act: str = "gelu",
                 device=None):
        super().__init__()
        self.router = nn.Linear(d_model, num_experts, bias=False,
                                device=device)
        self.experts_wi = nn.Parameter(
            torch.empty(num_experts, d_model, d_ff, device=device))
        self.experts_wo = nn.Parameter(
            torch.empty(num_experts, d_ff, d_model, device=device))
        self.top_k = top_k
        self.act = ACTIVATIONS[act]
        self.dtype = dtype

    def reset_parameters(self, gen: torch.Generator) -> None:
        # flax: the router's lecun normal; for the stacked experts
        # variance_scaling(1, "fan_in", "normal") counts the expert axis
        # into the fan-in (E·d for wi, E·ff for wo)
        lecun_truncated_normal_(self.router.weight, gen)
        for w in (self.experts_wi, self.experts_wo):
            normal_(w, math.sqrt(1.0 / (w.shape[0] * w.shape[1])), gen)

    def gate(self, x32: torch.Tensor):
        """fp32 (..., d) → ((..., E) renormalised top-k gate, (..., k)
        chosen experts)."""
        probs = torch.softmax(self.router(x32), dim=-1)
        top_p, top_i = torch.topk(probs, self.top_k, dim=-1)
        gate = torch.zeros_like(probs).scatter(-1, top_i, top_p)
        return gate / (gate.sum(dim=-1, keepdim=True) + 1e-9), top_i

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        gate, _ = self.gate(x32)
        h = self.act(torch.einsum("...d,edf->...ef", x32, self.experts_wi))
        y = torch.einsum("...ef,efd->...ed", h, self.experts_wo)
        return torch.einsum("...ed,...e->...d", y, gate).to(self.dtype)


class DepthwiseConv1d(nn.Module):
    """Depthwise convolution along the time axis of (B, T, C): one k-tap
    filter per channel, no bias, flax "SAME" padding, computed in `dtype`.
    The weight is (C, 1, k), torch's grouped layout of flax's (k, 1, C)."""

    def __init__(self, channels: int, kernel_size: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.empty(channels, 1, kernel_size, device=device))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        h = F.pad(x.to(self.dtype).transpose(1, 2), ((k - 1) // 2, k // 2))
        return F.conv1d(h, self.weight.to(self.dtype),
                        groups=self.weight.shape[0]).transpose(1, 2)


def sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / dim)
    out = np.zeros((length, dim), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out
