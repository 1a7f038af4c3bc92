"""Plain float32 Perceiver-TF encoder of YourMT3+, with its group
projection to the decoder's channels.

(B, T, F) features → conv pre-encoder (three residual blocks, each
halving the frequency axis) → spectral projection → K latents
cross-attend each frame's spectral tokens (query residual) → absolute
sinusoids along time, plus the trainable `pos_emb` (ptf_pos_enc
"trainable"; with "rope" the temporal blocks rotate q and k instead) →
ptf_num_blocks × [temporal self-attention over T for each latent,
spectral self-attention over K for each frame], each with a plain FF or
the top-k mixture of experts → final RMS norm → the group projection of
each channel's K/C latents to d_model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.model import (ACTS, FP32, gelu, linear, mha, rms_norm,
                             sinusoids)


def query_width(cfg: dict) -> int:
    return cfg["ptf_d_latent"] // _heads(cfg)


def _heads(cfg: dict) -> int:
    return max(1, cfg["ptf_d_latent"] // 32)


def _same(size, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + 3 - size, 0)
    return total // 2, total - total // 2


def conv3x3(x, w, b, stride, num):
    pt, pb = _same(x.shape[2], stride[0])
    pl, pr = _same(x.shape[3], stride[1])
    return F.conv2d(num.op(F.pad(x, (pl, pr, pt, pb))), num.op(w), b, stride)


def conv_pre_encoder(p, feats, blocks, num):
    """(B, T, F) → (B, T, ceil(F / 2**blocks), C)."""
    x = feats[:, None]
    for i in range(blocks):
        pre = f"encoder.pre_encoder.block.{i}."
        h = gelu(conv3x3(x, p[pre + "conv_down.weight"], p[pre + "conv_down.bias"],
                         (1, 2), num))
        r = h
        h = gelu(conv3x3(h, p[pre + "conv_a.weight"], p[pre + "conv_a.bias"], (1, 1), num))
        h = conv3x3(h, p[pre + "conv_b.weight"], p[pre + "conv_b.bias"], (1, 1), num)
        x = gelu(h + r)
    return x.permute(0, 2, 3, 1)


def ff(p, pre, x, act, drop, num):
    """A plain FF, dropout on the hidden."""
    return linear(drop(act(linear(x, p[pre + ".wi.weight"], num))),
                  p[pre + ".wo.weight"], num)


def moe_ff(p, pre, x, top_k, act, num):
    """Top-k routed experts: softmax router, the k largest renormalised."""
    probs = torch.softmax(linear(x, p[pre + ".router.weight"], num), dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    gate = torch.zeros_like(probs).scatter(-1, top_i, top_p)
    gate = gate / (gate.sum(-1, keepdim=True) + 1e-9)
    h = act(torch.einsum("...d,edf->...ef", num.op(x), num.op(p[pre + ".experts_wi"])))
    y = torch.einsum("...ef,efd->...ed", num.op(h), num.op(p[pre + ".experts_wo"]))
    return torch.einsum("...ed,...e->...d", y, gate)


def ptf_block(p, pre, x, cfg, drop, num, rope=False):
    act = ACTS[cfg["ptf_ff_act"]]
    h = rms_norm(x, p[pre + ".norm1.weight"])
    x = x + drop(mha(p, pre + ".attention", h, h, _heads(cfg), None, num, rope=rope))
    h = rms_norm(x, p[pre + ".norm2.weight"])
    if cfg["ptf_num_moe_experts"] > 0:
        y = moe_ff(p, pre + ".mlp", h, cfg["ptf_moe_topk"], act, num)
    else:
        y = ff(p, pre + ".mlp", h, act, drop, num)
    return x + drop(y)


def encode(p, feats, cfg, drop, num=FP32):
    """(B, T, F) features → (B, C, T, d_model) decoder memory."""
    if cfg["ptf_pos_enc"] not in ("trainable", "rope"):
        raise ValueError(f"no reference for ptf_pos_enc {cfg['ptf_pos_enc']!r}")
    B, T, _ = feats.shape
    D, K, H = cfg["ptf_d_latent"], cfg["ptf_num_latents"], _heads(cfg)
    tok = conv_pre_encoder(p, feats, 3, num)
    tok = linear(tok, p["encoder.spectral_proj.weight"], num)
    Fp = tok.shape[2]
    tok = tok.reshape(B * T, Fp, D)
    q = p["encoder.latent_array"][None].expand(B * T, K, D)
    h = mha(p, "encoder.sca.attention", rms_norm(q, p["encoder.sca.norm_q.weight"]),
            rms_norm(tok, p["encoder.sca.norm_kv.weight"]), H, None, num)
    z = q + h if cfg["ptf_sca_use_query_residual"] else h
    z = z + ff(p, "encoder.sca.ff", rms_norm(z, p["encoder.sca.ff_norm.weight"]),
               ACTS[cfg["ptf_ff_act"]], drop, num)
    z = z.reshape(B, T, K, D)
    z = z + sinusoids(T, D).to(z.device)[None, :, None, :]
    rope = cfg["ptf_pos_enc"] == "rope"
    if not rope:
        z = z + p["encoder.pos_emb"][:T][None, :, None, :]
    for i in range(cfg["ptf_num_blocks"]):
        zt = ptf_block(p, f"encoder.temporal_blocks.{i}",
                       z.transpose(1, 2).reshape(B * K, T, D), cfg, drop, num, rope)
        z = zt.reshape(B, K, T, D).transpose(1, 2)
        z = ptf_block(p, f"encoder.spectral_blocks.{i}", z.reshape(B * T, K, D),
                      cfg, drop, num).reshape(B, T, K, D)
    z = rms_norm(z, p["encoder.final_layer_norm.weight"])
    C = cfg["num_channels"]
    g = z.reshape(B, T, C, (K // C) * D).transpose(1, 2)
    return linear(g, p["projection.group_proj.weight"], num)


def shapes(cfg: dict, audio: dict) -> dict:
    """The encoder's and the projection's names and shapes (the conv
    pre-encoder takes one input channel, whatever the audio)."""
    D, dm, K, C = cfg["ptf_d_latent"], cfg["d_model"], cfg["ptf_num_latents"], cfg[
        "num_channels"]
    cc = cfg["conv_channels"]
    s = {"encoder.latent_array": (K, D), "encoder.spectral_proj.weight": (D, cc),
         "encoder.final_layer_norm.weight": (D,),
         "projection.group_proj.weight": (dm, (K // C) * D)}
    if cfg["ptf_pos_enc"] == "trainable":
        s["encoder.pos_emb"] = (1024, D)
    for i in range(3):
        pre = f"encoder.pre_encoder.block.{i}."
        s[pre + "conv_down.weight"] = (cc, 1 if i == 0 else cc, 3, 3)
        for c in ("conv_down", "conv_a", "conv_b"):
            s[pre + c + ".bias"] = (cc,)
        s[pre + "conv_a.weight"] = s[pre + "conv_b.weight"] = (cc, cc, 3, 3)
    for n in ("norm_q", "norm_kv", "ff_norm"):
        s[f"encoder.sca.{n}.weight"] = (D,)
    for n in "qkv":
        s[f"encoder.sca.attention.{n}.weight"] = (D, D)
    s["encoder.sca.attention.o.weight"] = (D, D)
    s["encoder.sca.ff.wi.weight"], s["encoder.sca.ff.wo.weight"] = (4 * D, D), (D, 4 * D)
    E = cfg["ptf_num_moe_experts"]
    for kind in ("temporal", "spectral"):
        for i in range(cfg["ptf_num_blocks"]):
            pre = f"encoder.{kind}_blocks.{i}"
            s[pre + ".norm1.weight"] = s[pre + ".norm2.weight"] = (D,)
            for n in "qkv":
                s[f"{pre}.attention.{n}.weight"] = (D, D)
            s[pre + ".attention.o.weight"] = (D, D)
            if E:
                s[pre + ".mlp.router.weight"] = (E, D)
                s[pre + ".mlp.experts_wi"] = (E, D, 4 * D)
                s[pre + ".mlp.experts_wo"] = (E, 4 * D, D)
            else:
                s[pre + ".mlp.wi.weight"], s[pre + ".mlp.wo.weight"] = (4 * D, D), (D, 4 * D)
    return s
