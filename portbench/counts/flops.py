"""Operations and bytes counted from shapes: the work the model needs.

A multiply-add counts 2 operations. Only products are counted (the
projections, attention, convolutions and FFs); norms, softmax and the
elementwise work are left out, as is the spectrogram frontend. Attention
counts the positions a query may see: a causal decoder query at position
p sees p + 1 keys. The mixture of experts counts its router and the
top-k experts a token is routed to, not the experts computed densely.
Backward is twice the forward, so a training step is three forwards.

`cfg` is the configuration file's "model" dict, `audio` its "audio",
`config` the whole file; the encoder's own count lives in
counts/encoders/<encoder>.py, named by the file's "encoder" key.
"""

from __future__ import annotations

import importlib

PEAK_BF16 = 989e12  # H100 SXM dense bf16, FLOP/s
PEAK_FP32 = 67e12  # H100 SXM fp32 outside the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12  # H100 SXM


def frames(audio: dict) -> int:
    return -(-audio["input_frames"] // audio["hop_length"])


def feature_bins(audio: dict) -> int:
    return audio["n_mels"] if audio["codec"] == "melspec" else audio["n_fft"] // 2 + 1


def encoder(config: dict):
    """The counts of the configuration's encoder: counts/encoders/<encoder>.py."""
    return importlib.import_module("counts.encoders." + config["encoder"])


def encoder_forward(config: dict, segments: int) -> float:
    """The configuration's encoder, with its projection to the decoder's
    channels, over a batch of `segments`."""
    return encoder(config).forward(config["model"], config["audio"], segments)


def _inner(cfg: dict) -> int:
    return cfg["num_heads"] * cfg["d_kv"]


def cross_kv(cfg: dict, audio: dict, streams: int) -> float:
    """The cross-attention K and V of every layer, per stream."""
    return streams * cfg["num_decoder_layers"] * 2 * 2 * frames(audio) * cfg[
        "d_model"] * _inner(cfg)


def decoder_position(cfg: dict, audio: dict, seen: int) -> float:
    """One stream, one position that sees `seen` keys: every layer and
    the LM head."""
    dm, inner = cfg["d_model"], _inner(cfg)
    layer = (4 * 2 * dm * inner + 2 * 2 * inner * seen  # self-attention
             + 2 * 2 * dm * inner + 2 * 2 * inner * frames(audio)  # cross
             + 3 * 2 * dm * cfg["d_ff"])  # gated FF
    return cfg["num_decoder_layers"] * layer + 2 * dm * cfg["vocab_size"]


def decode(cfg: dict, audio: dict, streams: int, steps: int) -> float:
    """A decode of `steps` positions for `streams` streams, with its cross
    K/V."""
    pos = sum(decoder_position(cfg, audio, p + 1) for p in range(steps))
    return cross_kv(cfg, audio, streams) + streams * pos


def train_step(config: dict, batch: int) -> float:
    """Forward and backward of one step at `batch` segments, all C
    channels teacher-forced over the whole target length."""
    cfg, audio = config["model"], config["audio"]
    streams = batch * cfg["num_channels"]
    fwd = encoder_forward(config, batch) + decode(
        cfg, audio, streams, cfg["max_target_length"])
    return 3 * fwd


def int4_cross_call(streams: int, heads: int, dk: int, T: int):
    """(bytes, operations) of one int4 cross-attention call: bf16 q and
    out, packed K and V, their fp32 scales, each moved once; q·k and w·v
    multiply-adds."""
    nbytes = (2 * streams * heads * dk * 2 + 2 * streams * heads * (dk // 2) * T
              + 2 * streams * heads * T * 4)
    return nbytes, 4 * streams * heads * T * dk


def paged_decode_call(streams: int, heads: int, dk: int, live: int):
    """(bytes, operations) of one self-attention read of `live` cached
    positions through the int8 paged cache: bf16 q and out, int8 K and V
    and their fp32 row scales, each moved once; q·k and w·v multiply-adds.
    The work any kernel must do, not the split-KV partials of one."""
    nbytes = 2 * streams * heads * dk * 2 + 2 * streams * heads * live * (dk + 4)
    return nbytes, 4 * streams * heads * live * dk


def least_time(nbytes: float, ops: float, peak_ops: float = PEAK_FP32) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / peak_ops)
