"""Plain float32 reference of the YourMT3+ multi-channel model.

One forward pass, written out in plain PyTorch over a name → tensor dict:
log-mel or log-magnitude frontend (torch.stft) → the configuration's
encoder (reference/encoders/<encoder>.py, named by the configuration
file's "encoder" key), which ends in C channels of decoder memory →
C-channel T5 decoder (relative position bias, gated-gelu FF) → LM head. The
teacher-forced logits are what both checks read: a served token is judged
by its gap below the reference's best logit at its position, a training
step by its loss and by what the gradient and Adam make of it.

Everything runs in float32 with TF32 off (the caller sets the flags,
`fp32_flags`). There is no cache, no batching trick and no kernel. The
names of the tensors are the checkpoint names of YourMT3+ (HF T5 style),
so one weight generator (harness/weights.py) fills both this reference and
the model under test from a seed.

`Numerics` puts a control in the reference's place: products with float8
(e4m3) operands, or decoder weights and K/V rows rounded to fewer integer
bits. In training, dropout and SpecAugment draw from a torch.Generator in
the order and shapes of the model under test, so the same seed gives the
same masks; `MaskSource` keeps the masks of the whole batch when the
reference runs in blocks of rows.
"""

from __future__ import annotations

import dataclasses
import importlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
NEG_INF = -1e9
Params = Dict[str, torch.Tensor]


def fp32_flags() -> None:
    """float32 products in float32: TF32 off for matmul and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# numerics of a control
# ---------------------------------------------------------------------------

def _round_rows(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric integer rounding of each row (last axis) to `bits` bits,
    returned dequantized."""
    top = 2 ** (bits - 1) - 1
    scale = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-30) / top
    return torch.clamp(torch.round(x / scale), -top - 1, top) * scale


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled float8 e4m3 rounding, straight-through gradient."""
    scale = torch.clamp(x.detach().abs().amax(), min=1e-30) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return x + (q - x.detach())


@dataclasses.dataclass(frozen=True)
class Numerics:
    """fp8_products: every product's operands rounded to float8 e4m3;
    weight_bits: decoder and LM-head weights rounded per output channel;
    self_kv_bits / cross_kv_bits: decoder K/V rounded per (head, position)
    row. 0 leaves a part in float32."""

    fp8_products: bool = False
    weight_bits: int = 0
    self_kv_bits: int = 0
    cross_kv_bits: int = 0

    def op(self, x: torch.Tensor) -> torch.Tensor:
        return _fp8(x) if self.fp8_products else x

    def dec_weight(self, w: torch.Tensor) -> torch.Tensor:
        return _round_rows(w, self.weight_bits) if self.weight_bits else w

    def kv(self, x: torch.Tensor, bits: int) -> torch.Tensor:
        return _round_rows(x, bits) if bits else x


FP32 = Numerics()


# ---------------------------------------------------------------------------
# dropout masks drawn as the model under test draws them
# ---------------------------------------------------------------------------

class MaskSource:
    """Dropout for one training step. With a generator, site i of the
    forward pass draws `torch.rand` of the whole batch's shape, as the model
    under test does, and keeps the rows [r0, r1) of the block being run;
    later blocks reuse the drawn masks. Without one, dropout is off."""

    def __init__(self, gen: Optional[torch.Generator], rate: float,
                 batch: int):
        self.gen, self.rate, self.batch = gen, rate, batch
        self.masks: List[torch.Tensor] = []
        self.rows = (0, batch)
        self.site = 0

    def block(self, r0: int, r1: int) -> None:
        self.rows, self.site = (r0, r1), 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.gen is None or self.rate == 0.0:
            return x
        r0, r1 = self.rows
        per_row = x.shape[0] // (r1 - r0)
        if self.site == len(self.masks):
            shape = (per_row * self.batch, *x.shape[1:])
            self.masks.append(torch.rand(shape, generator=self.gen,
                                         device=x.device) < 1.0 - self.rate)
        mask = self.masks[self.site][r0 * per_row: r1 * per_row]
        self.site += 1
        return torch.where(mask, x / (1.0 - self.rate), torch.zeros((), device=x.device))


def spec_augment_masks(gen: torch.Generator, batch: int, frames: int,
                       bins: int, device, time_masks: int = 2,
                       time_width: int = 32, freq_masks: int = 2,
                       freq_width: int = 48) -> torch.Tensor:
    """(batch, frames, bins) bool, True where masked: per example, spans of
    width uniform in [0, max] starting uniform in [0, length - width),
    time spans first, each drawn as widths then starts."""
    def axis(length, width, n):
        w = torch.randint(0, width + 1, (batch, n, 1), generator=gen,
                          device=device)
        span = torch.clamp(length - w, min=1)
        s = torch.minimum((torch.rand((batch, n, 1), generator=gen,
                                      device=device) * span).long(), span - 1)
        pos = torch.arange(length, device=device)[None, None, :]
        return ((pos >= s) & (pos < s + w)).any(dim=1)
    t = axis(frames, time_width, time_masks)
    f = axis(bins, freq_width, freq_masks)
    return t[:, :, None] | f[:, None, :]


# ---------------------------------------------------------------------------
# frontend
# ---------------------------------------------------------------------------

def mel_filterbank(n_freqs: int, n_mels: int, sample_rate: int,
                   f_min: float, f_max: float) -> np.ndarray:
    """(n_freqs, n_mels) triangular HTK-mel filters, no normalisation."""
    def to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def to_hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    freqs = np.linspace(0, sample_rate // 2, n_freqs)
    edges = to_hz(np.linspace(to_mel(f_min), to_mel(f_max), n_mels + 2))
    lo, mid, hi = edges[:-2], edges[1:-1], edges[2:]
    up = (freqs[:, None] - lo[None]) / (mid - lo)[None]
    down = (hi[None] - freqs[:, None]) / (hi - mid)[None]
    return np.maximum(0.0, np.minimum(up, down))


def features(audio: torch.Tensor, a: dict) -> torch.Tensor:
    """(B, samples) → (B, frames, bins): centred reflect-padded STFT with
    a periodic Hann window, magnitude, mel filters (codec "melspec"; none
    for "spec"), log with a floor."""
    win = torch.hann_window(a["n_fft"], periodic=True, dtype=F32,
                            device=audio.device)
    spec = torch.stft(audio.to(F32), a["n_fft"], a["hop_length"], window=win,
                      center=True, pad_mode="reflect", return_complex=True)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-12)  # (B, bins, T)
    if a["power"] == 2.0:
        mag = mag * mag
    if a["codec"] == "spec":
        return torch.log(torch.clamp(mag.transpose(1, 2), min=a["log_offset"]))
    fb = torch.tensor(mel_filterbank(a["n_fft"] // 2 + 1, a["n_mels"],
                                     a["sample_rate"], a["f_min"], a["f_max"]),
                      dtype=F32, device=audio.device)
    mel = torch.einsum("bft,fm->btm", mag, fb)
    return torch.log(torch.clamp(mel, min=a["log_offset"]))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def gelu(x):
    return F.gelu(x, approximate="tanh")


ACTS = {"gelu": gelu, "silu": F.silu}


def rms_norm(x, w, eps: float = 1e-6):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) * w


def linear(x, w, num: Numerics):
    return num.op(x) @ num.op(w).t()


def attention(q, k, v, bias, num: Numerics):
    """(N, H, Tq, d), (N, H, Tk, d) → (N, H, Tq, d); no 1/sqrt(d) scale."""
    logits = num.op(q) @ num.op(k).transpose(-1, -2)
    if bias is not None:
        logits = logits + bias
    return num.op(torch.softmax(logits, dim=-1)) @ num.op(v)


def heads(x, h):
    n, t, d = x.shape
    return x.reshape(n, t, h, d // h).transpose(1, 2)


def merge(x):
    n, h, t, d = x.shape
    return x.transpose(1, 2).reshape(n, t, h * d)


def rope_rotate(x: torch.Tensor, base: float = 10000.0) -> torch.Tensor:
    """Rotary positions over the sequence axis of (N, H, T, d): element i
    pairs with i + d/2 and the pair turns by t / base^(i / (d/2))."""
    T, half = x.shape[-2], x.shape[-1] // 2
    freqs = 1.0 / base ** (torch.arange(half, dtype=F32, device=x.device) / half)
    ang = torch.arange(T, dtype=F32, device=x.device)[:, None] * freqs[None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def mha(p, pre, xq, xkv, h, bias, num, weight=None, kv_bits=0, rope=False):
    w = weight or (lambda name: p[name])
    q = heads(linear(xq, w(pre + ".q.weight"), num), h)
    k = heads(num.kv(linear(xkv, w(pre + ".k.weight"), num).reshape(
        *xkv.shape[:2], h, -1), kv_bits).reshape(*xkv.shape[:2], -1), h)
    v = heads(num.kv(linear(xkv, w(pre + ".v.weight"), num).reshape(
        *xkv.shape[:2], h, -1), kv_bits).reshape(*xkv.shape[:2], -1), h)
    if rope:
        q, k = rope_rotate(q), rope_rotate(k)
    return linear(merge(attention(q, k, v, bias, num)), w(pre + ".o.weight"), num)


def sinusoids(length: int, dim: int) -> torch.Tensor:
    pos = np.arange(length)[:, None]
    i = np.arange(dim // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / dim)
    out = np.zeros((length, dim), np.float32)
    out[:, 0::2], out[:, 1::2] = np.sin(ang), np.cos(ang)
    return torch.from_numpy(out)


def relative_bucket(rel: torch.Tensor, num_buckets: int,
                    max_distance: int) -> torch.Tensor:
    """T5's causal bucketing of key - query distances, in fp32."""
    n = torch.clamp(-rel, min=0)
    exact = num_buckets // 2
    f32 = lambda v: torch.full((), v, dtype=F32, device=rel.device)  # noqa: E731
    large = exact + (torch.log(n.to(F32) / f32(exact) + 1e-6)
                     / f32(np.float32(np.log(max_distance / exact)))
                     * (num_buckets - exact)).to(rel.dtype)
    return torch.where(n < exact, n, torch.clamp(large, max=num_buckets - 1))


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def decode_teacher_forced(p, memory, input_ids, cfg, drop, num=FP32):
    """memory (B, C, T, D), input ids (B, C, L) → logits (B, C, L, V)."""
    B, C, L = input_ids.shape
    N = B * C
    H = cfg["num_heads"]
    mem = memory.reshape(N, memory.shape[2], memory.shape[3])

    def w(name):  # decoder weights, rounded under a control
        return num.dec_weight(p[name])

    y = drop(p["shared.weight"][input_ids.reshape(N, L)])
    pos = torch.arange(L, device=y.device, dtype=torch.int32)
    table = p["decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    buckets = relative_bucket(pos[None, :] - pos[:, None], cfg["rel_attn_num_buckets"],
                              cfg["rel_attn_max_distance"])
    causal = torch.where(pos[None, :] > pos[:, None], NEG_INF, 0.0)
    bias = (table[buckets.long()].permute(2, 0, 1) + causal)[None]
    for i in range(cfg["num_decoder_layers"]):
        pre = f"decoder.block.{i}.layer."
        h = rms_norm(y, p[pre + "0.layer_norm.weight"])
        y = y + drop(mha(p, pre + "0.SelfAttention", h, h, H, bias, num, w,
                         num.self_kv_bits))
        h = rms_norm(y, p[pre + "1.layer_norm.weight"])
        y = y + drop(mha(p, pre + "1.EncDecAttention", h, mem, H, None, num, w,
                         num.cross_kv_bits))
        h = rms_norm(y, p[pre + "2.layer_norm.weight"])
        f = gelu(linear(h, w(pre + "2.DenseReluDense.wi_0.weight"), num)) * linear(
            h, w(pre + "2.DenseReluDense.wi_1.weight"), num)
        y = y + drop(linear(drop(f), w(pre + "2.DenseReluDense.wo.weight"), num))
    y = rms_norm(y, p["decoder.final_layer_norm.weight"])
    return linear(y, w("lm_head.weight"), num).reshape(B, C, L, -1)


def shift_right(labels: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(labels[..., :1]), labels[..., :-1]], -1)


def encoder_of(config: dict):
    """The configuration's encoder module: reference/encoders/<encoder>.py."""
    return importlib.import_module("reference.encoders." + config["encoder"])


def logits(p, audio, ids, config, num=FP32, drop=None, feats=None):
    """Raw audio (B, samples) and served ids (B, C, L) → teacher-forced
    logits (B, C, L, V): position l is the reference's prediction of ids[l]."""
    drop = drop or (lambda x: x)
    cfg = config["model"]
    if feats is None:
        feats = features(audio, config["audio"])
    memory = encoder_of(config).encode(p, feats, cfg, drop, num)
    return decode_teacher_forced(p, memory, shift_right(ids), cfg, drop, num)


def param_shapes(config: dict) -> Dict[str, tuple]:
    """The name → shape table of the model, as the checkpoint names it."""
    cfg = config["model"]
    dm, dkv, H, vocab = cfg["d_model"], cfg["d_kv"], cfg["num_heads"], cfg["vocab_size"]
    s = {"shared.weight": (vocab, dm), "lm_head.weight": (vocab, dm),
         "decoder.final_layer_norm.weight": (dm,),
         **encoder_of(config).shapes(cfg, config["audio"])}

    def attn(pre, d, inner):
        for n in "qkv":
            s[f"{pre}.{n}.weight"] = (inner, d)
        s[f"{pre}.o.weight"] = (d, inner)

    for i in range(cfg["num_decoder_layers"]):
        pre = f"decoder.block.{i}.layer."
        attn(pre + "0.SelfAttention", dm, H * dkv)
        attn(pre + "1.EncDecAttention", dm, H * dkv)
        for j in range(3):
            s[f"{pre}{j}.layer_norm.weight"] = (dm,)
        s[pre + "2.DenseReluDense.wi_0.weight"] = (cfg["d_ff"], dm)
        s[pre + "2.DenseReluDense.wi_1.weight"] = (cfg["d_ff"], dm)
        s[pre + "2.DenseReluDense.wo.weight"] = (dm, cfg["d_ff"])
    s["decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"] = (
        cfg["rel_attn_num_buckets"], H)
    return s


def token_nll(lg: torch.Tensor, labels: torch.Tensor):
    """Summed negative log-likelihood of the non-pad labels, and their count."""
    mask = (labels != 0).to(F32)
    ll = torch.gather(torch.log_softmax(lg, -1), -1, labels[..., None])[..., 0]
    return -(ll * mask).sum(), mask.sum()


def global_clip(grads: Params, max_norm: float) -> Params:
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    if float(norm) < max_norm:
        return grads
    return {k: g / norm * max_norm for k, g in grads.items()}


def cosine_lr(count: int, base: float, warmup: int, total: int,
              final_scale: float = 0.1) -> float:
    """Linear warm-up from 0, then cosine decay to final_scale · base."""
    if count < warmup:
        return base * count / warmup
    decay = max(total, warmup + 1) - warmup
    c = min(count - warmup, decay)
    return base * ((1 - final_scale) * 0.5 * (1 + math.cos(math.pi * c / decay))
                   + final_scale)
