"""YMT3: full model assembly (encoder + projection + decoder).

The audio frontend (ops/frontend.py) runs outside this module; the model
consumes (B, T, F) features. Dropout (rate `cfg.dropout_rate`) is active in
train() mode and draws from the generator given to
`set_dropout_generator`; eval() mode is the reference's
`deterministic=True`. Parameter names are those of the reference
checkpoint naming: `shared.weight`, `lm_head.weight`, `encoder.*`,
`decoder.*` (see weights.py).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config.model import ModelConfig
from ..ops.decode_attention import empty_paged_cache, empty_paged_scales
from ..ops.weight_quant import quantize_decoder_weights
from ..parallel.tensor_parallel import gather_from, local
from ..tokens.codec import PAD_ID
from .conformer import ConformerEncoder
from .conv_block import Conv2dSame
from .layers import (DepthwiseConv1d, Dropout, FeedForward, MoEFeedForward,
                     MultiHeadAttention, QuantDense, RelativePositionBias,
                     lecun_truncated_normal_, normal_)
from .perceiver_tf import PerceiverTFEncoder
from .projection import EncoderProjection
from .t5 import INT8_SELF, MultiChannelT5Decoder, T5Decoder, T5Encoder, compute_dtype


class YMT3(nn.Module):
    def __init__(self, cfg: ModelConfig, in_features: int = 512):
        super().__init__()
        if cfg.encoder_type == "t5":
            encoder = T5Encoder(cfg, in_features)
        elif cfg.encoder_type == "perceiver-tf":
            encoder = PerceiverTFEncoder(cfg)
        elif cfg.encoder_type == "conformer":
            encoder = ConformerEncoder(cfg, in_features)
        else:
            raise ValueError(f"unknown encoder_type {cfg.encoder_type!r}")
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = encoder
        self.projection = EncoderProjection(cfg)
        self.multi = cfg.decoder_type == "multi-t5" or cfg.num_channels > 1
        self.decoder = (MultiChannelT5Decoder if self.multi else T5Decoder)(cfg)
        self.lm_head = QuantDense(cfg.d_model, cfg.vocab_size, compute_dtype(cfg))
        self.embed_tp = None  # the model axis when `shared` is split on d_model
        if cfg.weight_quant != "none":
            quantize_decoder_weights(self, cfg.weight_quant)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """Random init with the reference initialisers' distributions:
        lecun normal for dense and conv kernels, zero conv biases,
        N(0, 0.02) for bias tables, latents and position tables, fan-in
        normal for the attention, FF and expert weights."""
        for mod in self.modules():
            if isinstance(mod, (QuantDense, DepthwiseConv1d)):
                lecun_truncated_normal_(mod.weight, gen)
            elif isinstance(mod, Conv2dSame):
                lecun_truncated_normal_(mod.weight, gen)
                nn.init.zeros_(mod.bias)
        for mod in self.modules():
            if isinstance(mod, (MultiHeadAttention, FeedForward, MoEFeedForward)):
                mod.reset_parameters(gen)
            elif isinstance(mod, RelativePositionBias):
                normal_(mod.weight, 0.02, gen)
        normal_(self.shared.weight, 1.0, gen)
        for name in ("pos_embed", "latent_array", "pos_emb"):
            if hasattr(self.encoder, name):
                normal_(getattr(self.encoder, name), 0.02, gen)
        for mod in self.modules():
            if isinstance(mod, QuantDense) and mod.weight_quant != "none":
                mod.requantize()

    def set_dropout_generator(self, gen: Optional[torch.Generator],
                              shard: Tuple[int, int] = (0, 1)) -> None:
        """Every dropout site draws from `gen` (a generator on the model's
        device) in train() mode. shard = (rank, world) on the data axis:
        each site draws the mask of the global batch and keeps this rank's
        rows (every rank passes a generator in the same state)."""
        for mod in self.modules():
            if isinstance(mod, Dropout):
                mod.generator, mod.shard = gen, shard

    @property
    def dtype(self) -> torch.dtype:
        return compute_dtype(self.cfg)

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        if self.embed_tp is not None:  # this rank's d_model columns, gathered
            return gather_from(F.embedding(ids, local(self.shared.weight)),
                               self.embed_tp).to(self.dtype)
        return self.shared(ids).to(self.dtype)

    # ---- encoding ------------------------------------------------------
    def encode(self, feats: torch.Tensor) -> torch.Tensor:
        """(B, T, F) → decoder memory (B, C, T', D)."""
        return self.projection(self.encoder(feats))

    # ---- teacher-forced forward ---------------------------------------
    def forward(self, feats: torch.Tensor,
                decoder_input_ids: torch.Tensor) -> torch.Tensor:
        """feats (B, T, F), ids (B, C, L) → logits (B, C, L, V) fp32."""
        memory = self.encode(feats)
        y = self.embed(decoder_input_ids)
        if self.multi:
            h = self.decoder(y, memory)
        else:
            h = self.decoder(y[:, 0], memory[:, 0])[:, None]
        return self.lm_head(h).to(torch.float32)

    # ---- decode-time methods (explicit caches) --------------------------
    def init_cross_kv(self, memory: torch.Tensor) -> List:
        """memory (B, C, T, D) → per-layer cross KV, channel-folded."""
        if self.multi:
            return self.decoder.init_cross_kv(memory)
        return self.decoder.init_cross_kv(memory[:, 0])

    def decode_step(self, token_ids: torch.Tensor, pos, self_kvs: List,
                    cross_kvs: List, kv_len: int = 0):
        """token_ids (S, 1) → ((S, vocab) fp32 logits, self caches). pos: a
        host int, or a 0-dim int64 tensor on the caches' device where the
        self caches are dense (T5Decoder.decode_step)."""
        h, kvs = self.decoder.decode_step(self.embed(token_ids), pos,
                                          self_kvs, cross_kvs, kv_len=kv_len)
        return self.lm_head(h).to(torch.float32)[:, 0, :], kvs

    # ---- cache scaffolding ---------------------------------------------
    def empty_self_kvs(self, batch_streams: int, max_len: int,
                       device=None) -> List:
        c = self.cfg
        device = device if device is not None else self.shared.weight.device
        kvh = c.decoder_kv_heads or c.num_heads
        dt = self.dtype
        n = c.num_decoder_layers
        if c.kv_quant == "int4":
            # interleaved nibbles (S, H, L, dk/2) uint8 + fp32 row scales
            vals = (batch_streams, kvh, max_len, c.d_kv // 2)
            scls = (batch_streams, kvh, max_len)

            def pair():
                return (torch.zeros(vals, dtype=torch.uint8, device=device),
                        torch.zeros(scls, dtype=torch.float32, device=device))
            return [(pair(), pair()) for _ in range(n)]
        if c.use_pallas_decode:
            # pages of 64 for short decodes, 128 for long ones
            block = 64 if max_len <= 256 else 128
            padded = -(-max_len // block) * block
            if c.kv_quant in INT8_SELF:
                def pair():
                    return (empty_paged_cache(batch_streams, kvh, c.d_kv, padded,
                                              block, torch.int8, device),
                            empty_paged_scales(batch_streams, kvh, padded, block,
                                               device))
                return [(pair(), pair()) for _ in range(n)]
            return [(empty_paged_cache(batch_streams, kvh, c.d_kv, padded,
                                       block, dt, device),
                     empty_paged_cache(batch_streams, kvh, c.d_kv, padded,
                                       block, dt, device))
                    for _ in range(n)]
        if c.kv_quant in INT8_SELF:
            # zero scales make unwritten positions contribute 0 logits
            vals = (batch_streams, kvh, max_len, c.d_kv)
            scls = (batch_streams, kvh, max_len)

            def pair():
                return (torch.zeros(vals, dtype=torch.int8, device=device),
                        torch.zeros(scls, dtype=torch.float32, device=device))
            return [(pair(), pair()) for _ in range(n)]
        shape = (batch_streams, kvh, max_len, c.d_kv)
        return [(torch.zeros(shape, dtype=dt, device=device),
                 torch.zeros(shape, dtype=dt, device=device))
                for _ in range(n)]


def shift_right(labels: torch.Tensor, start_id: int = 0) -> torch.Tensor:
    """(…, L) labels → decoder inputs: [start, y₀, …, y_{L-2}]."""
    start = torch.full((*labels.shape[:-1], 1), start_id, dtype=labels.dtype,
                       device=labels.device)
    return torch.cat([start, labels[..., :-1]], dim=-1)


def ce_sums(logits: torch.Tensor, labels: torch.Tensor,
            label_smoothing: float = 0.0):
    """Pad-masked token cross entropy as sums: → (negative log-likelihood
    summed over the non-pad tokens, correct predictions among them, their
    count), each a 0-dim fp32 tensor. With label smoothing ε the target
    log-likelihood is (1 - ε)·log p(y) + ε·mean_v log p(v)."""
    mask = (labels != PAD_ID).to(torch.float32)
    logz = torch.log_softmax(logits, dim=-1)
    ll = torch.gather(logz, -1, labels[..., None].long())[..., 0]
    if label_smoothing > 0.0:
        ll = (1.0 - label_smoothing) * ll + label_smoothing * logz.mean(-1)
    correct = ((logits.argmax(-1) == labels).to(torch.float32) * mask).sum()
    return -(ll * mask).sum(), correct, mask.sum()


def ce_loss(logits: torch.Tensor, labels: torch.Tensor,
            label_smoothing: float = 0.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad-masked token cross entropy, the mean over non-pad tokens.

    logits (B, C, L, V) fp32, labels (B, C, L) int → (scalar loss,
    accuracy)."""
    nll, correct, count = ce_sums(logits, labels, label_smoothing)
    denom = torch.clamp(count, min=1.0)
    return nll / denom, correct / denom
