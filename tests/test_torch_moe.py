"""The port's mixture-of-experts FF and the MoE flagship against the JAX
package: `MoEFeedForward` alone, then perceiver_tf_mc13_moe cut to a tiny
width (conv pre-encoder, Perceiver-TF with the MoE FF in every temporal
and spectral block, group projection to 13 channels, multi-channel T5
decoder) in fp32 with kv_quant="int8c4p" and weight_quant="int8",
weights bridged from JAX.

As in tests/test_torch_flagship.py, the decoder memory leaves the bf16
group projection one bf16 ulp apart in a few entries, so the decode is
held on JAX's memory."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import yourmt3_tpu.api as japi
from yourmt3_tpu.config.model import PERCEIVER_TF_MC13_MOE as JAX_MOE
from yourmt3_tpu.models.layers import MoEFeedForward as JaxMoE
from yourmt3_tpu_torch import api
from yourmt3_tpu_torch.config.model import PERCEIVER_TF_MC13_MOE
from yourmt3_tpu_torch.data.audio_io import slice_padded_array
from yourmt3_tpu_torch.models.decoding import greedy_decode
from yourmt3_tpu_torch.models.layers import MoEFeedForward
from yourmt3_tpu_torch.ops.int4_cross_attention import int4_cross_attention
from yourmt3_tpu_torch.weights import state_dict_from_jax

from torch_port_util import numpy_params, one_intra_op_thread, sine_song  # noqa: F401

TASK = "mc13_full_plus_256"
TINY = dict(d_model=64, d_kv=16, num_heads=4, d_ff=128, num_decoder_layers=2,
            ptf_d_latent=64, ptf_num_blocks=1, conv_channels=8)
FLAGSHIP = dict(kv_quant="int8c4p", weight_quant="int8")
BATCH = 2
# fp32 on both sides, sums in another order
TOL_FF, TOL_ENC = 1e-5, 1e-4
# the least gap between a token's k + 1 largest router probabilities that
# the test inputs keep, so that top-k has no near-ties to break (or to
# order) differently
MIN_GAP = 1e-5


def _jax_moe(x, num_experts, d_ff, top_k, act, seed=0):
    """(JAX module, its params, its output, its top-k indices) on x."""
    mod = JaxMoE(num_experts=num_experts, d_ff=d_ff, d_model=x.shape[-1],
                 top_k=top_k, act=act, dtype=jnp.float32)
    params = mod.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    out = np.asarray(mod.apply(params, jnp.asarray(x)))
    p = params["params"]
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"]["kernel"], axis=-1)
    _, top_i = jax.lax.top_k(probs, top_k)
    return p, out, np.asarray(top_i), np.asarray(probs)


@pytest.mark.parametrize("top_k,act", [(2, "gelu"), (1, "gelu"), (2, "silu"),
                                       (3, "relu")])
def test_moe_feed_forward_matches_jax(top_k, act):
    """Router, top-k gate and the dense expert products within TOL_FF, the
    chosen experts identical, on inputs with no tied router
    probabilities."""
    E, d, ff = 8, 32, 64
    x = np.random.default_rng(top_k).standard_normal((3, 40, d)).astype(np.float32)
    p, want, top_j, probs = _jax_moe(x, E, ff, top_k, act)
    top = np.sort(probs, axis=-1)[..., ::-1][..., :top_k + 1]
    assert (top[..., :-1] - top[..., 1:]).min() > MIN_GAP  # no ties
    mod = MoEFeedForward(E, d, ff, torch.float32, top_k=top_k, act=act)
    mod.load_state_dict({
        "router.weight": torch.from_numpy(np.asarray(p["router"]["kernel"]).T.copy()),
        "experts_wi": torch.from_numpy(np.array(p["wi"])),
        "experts_wo": torch.from_numpy(np.array(p["wo"]))}, strict=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x))
        gate, top_p = mod.gate(torch.from_numpy(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(top_p.numpy(), top_j)
    assert np.abs(got.numpy() - want).max() < TOL_FF
    # the gate is the renormalised top-k probabilities, zero elsewhere
    assert (gate > 0).sum(-1).eq(top_k).all()
    assert torch.allclose(gate.sum(-1), torch.ones(()), atol=1e-6)


def test_moe_output_takes_the_compute_dtype():
    """bf16 activations in, bf16 out; the experts compute in fp32."""
    mod = MoEFeedForward(4, 16, 32, torch.bfloat16)
    mod.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 16, generator=torch.Generator().manual_seed(1))
    ref = MoEFeedForward(4, 16, 32, torch.float32)
    ref.load_state_dict(mod.state_dict(), strict=True)
    with torch.no_grad():
        got = mod(x.to(torch.bfloat16))
        want = ref(x.to(torch.bfloat16).float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.fixture(scope="module")
def bundles():
    """(JAX bundle, port bundle): the tiny MoE flagship in fp32 with
    identical weights; the JAX params carry its `qweights` collection."""
    jb = japi.init_model(model_cfg=JAX_MOE.replace(**TINY), task=TASK,
                         compute_dtype="float32", **FLAGSHIP)
    pb = api.init_model(model_cfg=PERCEIVER_TF_MC13_MOE.replace(**TINY),
                        task=TASK, device="cpu", compute_dtype="float32",
                        **FLAGSHIP)
    pb.model.load_state_dict(state_dict_from_jax(numpy_params(jb.params)),
                             strict=True)
    return jb, pb


@pytest.fixture(scope="module")
def song(bundles):
    ac = bundles[1].audio_cfg
    segments, starts = slice_padded_array(sine_song(4.0), ac.input_frames)
    assert segments.shape[0] == BATCH
    return segments, (starts / ac.sample_rate).tolist()


@pytest.fixture(scope="module")
def jax_memory(bundles, song):
    jb, _ = bundles
    return japi._encode_batch(jb.model, jb.params, jb.frontend,
                              jnp.asarray(song[0]))


def _to_torch(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


def test_tiny_moe_flagship_encode_matches_jax(bundles, song):
    """The Perceiver-TF output with the MoE FF in every block, within
    TOL_ENC; every block's FF is the MoE and reads fp32 weights only."""
    jb, pb = bundles
    blocks = list(pb.model.encoder.temporal_blocks) + list(pb.model.encoder.spectral_blocks)
    assert all(isinstance(b.mlp, MoEFeedForward) for b in blocks)
    feats = jb.frontend(jnp.asarray(song[0]))
    enc_j = jb.model.apply(jb.params, feats, method=lambda m, f: m.encoder(f))
    with torch.no_grad():
        enc_p = pb.model.encoder(pb.frontend(torch.from_numpy(song[0])))
    assert enc_p.shape == (BATCH, 256, 26, TINY["ptf_d_latent"])
    err = np.abs(enc_p.numpy() - np.asarray(enc_j)).max()
    print(f"MoE flagship encoder: max |diff| {err:.2e}")
    assert err < TOL_ENC


def test_moe_flagship_greedy_tokens_match_jax(bundles, song, jax_memory):
    """Both sides decode JAX's memory (int8 self cache, int4 cross K/V
    through the kernel's plain version, int8 decoder weights): identical
    greedy token ids, then identical notes and error counts through
    transcribe_segments_array."""
    jb, pb = bundles
    segments, starts = song
    L = pb.task_manager.max_token_length
    prefix = pb.task_manager.subtask_prefix_ids()
    jprefix = jnp.asarray(prefix, jnp.int32) if prefix else None
    ids_j = np.asarray(japi._decode_batch(
        jb.model, jb.params, jax_memory,
        japi._cross_kv_batch(jb.model, jb.params, jax_memory), L, jprefix))
    mem = _to_torch(jax_memory).to(torch.bfloat16)
    launches = int4_cross_attention.launches
    with torch.no_grad():
        ids_p = greedy_decode(pb.model, mem, L, prefix_ids=prefix).numpy()
    assert int4_cross_attention.launches == launches  # CPU: plain version
    np.testing.assert_array_equal(ids_p, ids_j)

    def jax_memory_of(bundle, audio):
        return _to_torch(japi._encode_batch(jb.model, jb.params, jb.frontend,
                                            jnp.asarray(audio))).to(torch.bfloat16)

    notes_j, err_j = japi.transcribe_segments_array(jb, segments, starts,
                                                    batch_size=BATCH)
    mp = pytest.MonkeyPatch()
    mp.setattr(api, "_encode_batch", jax_memory_of)
    try:
        notes_p, err_p = api.transcribe_segments_array(pb, segments, starts,
                                                       batch_size=BATCH)
    finally:
        mp.undo()
    assert [dataclasses.astuple(n) for n in notes_p] == \
        [dataclasses.astuple(n) for n in notes_j]
    assert dataclasses.astuple(err_p) == dataclasses.astuple(err_j)


def test_full_width_moe_flagship_builds_and_steps():
    """perceiver_tf_mc13_moe at its published width with int8c4p and int8
    decoder weights: 8 experts of (128 → 512 → 128) in each of the 6
    blocks, fp32 and unquantized; one decode step of the 13 channels."""
    b = api.init_model("perceiver_tf_mc13_moe", TASK, device="cpu", **FLAGSHIP)
    enc = b.model.encoder
    for blk in list(enc.temporal_blocks) + list(enc.spectral_blocks):
        assert blk.mlp.experts_wi.shape == (8, 128, 512)
        assert blk.mlp.experts_wo.shape == (8, 512, 128)
        assert blk.mlp.router.weight.dtype == torch.float32
    assert len(enc.temporal_blocks) == 3 and enc.pos_emb.shape == (1024, 128)
    mem = torch.randn(1, 13, 256, 512, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        cross = b.model.init_cross_kv(mem.to(torch.bfloat16))
        kv = b.model.empty_self_kvs(13, 256)
        logits, _ = b.model.decode_step(torch.zeros((13, 1), dtype=torch.long),
                                        0, kv, cross)
    assert logits.shape == (13, b.cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
