"""Operations of the Perceiver-TF encoder and its group projection, per
batch of segments (the conventions of counts/flops.py)."""

from __future__ import annotations

from counts.flops import feature_bins, frames


def forward(cfg: dict, audio: dict, segments: int) -> float:
    """Conv pre-encoder, Perceiver-TF and the group projection."""
    T, f = frames(audio), feature_bins(audio)
    C, D, K = cfg["conv_channels"], cfg["ptf_d_latent"], cfg["ptf_num_latents"]
    ops = 0.0
    cin = 1
    for _ in range(3):  # each block halves the frequency axis ("SAME")
        f = -(-f // 2)
        ops += 2 * T * f * C * 9 * (cin + 2 * C)
        cin = C
    ops += 2 * T * f * C * D  # spectral projection
    ff = (2 * 2 * D * 4 * D)  # per token of a plain FF
    ops += T * (2 * K * D * D * 2 + 2 * 2 * f * D * D  # q, o; k, v
                + 2 * 2 * K * f * D + K * ff)  # attention; FF
    E, k = cfg["ptf_num_moe_experts"], cfg["ptf_moe_topk"]
    tok_ff = (k * ff + 2 * D * E) if E else ff
    for seq, length in ((K, T), (T, K)):  # temporal, spectral blocks
        ops += cfg["ptf_num_blocks"] * seq * (
            4 * 2 * length * D * D + 2 * 2 * length * length * D + length * tok_ff)
    ops += 2 * T * K * D * cfg["d_model"]  # group projection
    return ops * segments
