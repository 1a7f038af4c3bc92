"""Operations of the T5 encoder, per batch of segments (the conventions of
counts/flops.py; its projection to the decoder is the identity)."""

from __future__ import annotations

from counts.flops import feature_bins, frames


def forward(cfg: dict, audio: dict, segments: int) -> float:
    """Input projection, then each layer's q, k, v and o, its attention
    over all T frames and its gated FF, for every frame."""
    T, f = frames(audio), feature_bins(audio)
    dm, inner, dff = cfg["d_model"], cfg["num_heads"] * cfg["d_kv"], cfg["d_ff"]
    layer = 4 * 2 * dm * inner + 2 * 2 * T * inner + 3 * 2 * dm * dff
    return segments * T * (2 * f * dm + cfg["num_encoder_layers"] * layer)
