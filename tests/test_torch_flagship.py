"""The port's flagship slice against the JAX package: perceiver_tf_mc13
cut to a tiny width (same structure: conv pre-encoder, Perceiver-TF,
group projection to 13 channels, multi-channel T5 decoder) in fp32, with
kv_quant="int8c4p" (int8 self cache, int4 cross K/V through the kernel's
plain version) and weight_quant="int8", weights bridged from JAX.

The decoder memory leaves the projection in bf16 on both sides, and an
fp32 encoder difference of ~1e-5 moves about 0.3 % of its entries by one
bf16 ulp; through int4 cross K/V that is enough to flip a greedy token
now and then (about 2 % of the tokens of the test song diverge). So the
memory is held to its one-ulp bound on its own, and the decode and
transcription tests feed both sides JAX's memory.
"""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import yourmt3_tpu.api as japi
from yourmt3_tpu.config.model import PERCEIVER_TF_MC13 as JAX_FLAGSHIP
from yourmt3_tpu.models.conv_block import ConvPreEncoder as JaxConvPreEncoder
from yourmt3_tpu.models.ymt3 import YMT3 as JaxYMT3
from yourmt3_tpu.ops.weight_quant import quantize_decoder_weights as jax_wq
from yourmt3_tpu.train.import_torch import reference_style_state_dict
from yourmt3_tpu_torch import api
from yourmt3_tpu_torch.config.model import PERCEIVER_TF_MC13
from yourmt3_tpu_torch.data.audio_io import slice_padded_array
from yourmt3_tpu_torch.models.decoding import beam_decode, greedy_decode
from yourmt3_tpu_torch.models.layers import QuantDense
from yourmt3_tpu_torch.models.ymt3 import YMT3
from yourmt3_tpu_torch.ops.int4_cross_attention import int4_cross_attention
from yourmt3_tpu_torch.tokens.codec import EOS_ID
from yourmt3_tpu_torch.weights import state_dict_from_jax

from torch_port_util import numpy_params, sine_song

TASK = "mc13_full_plus_256"
TINY = dict(d_model=64, d_kv=16, num_heads=4, d_ff=128, num_decoder_layers=2,
            ptf_d_latent=64, ptf_num_blocks=1, conv_channels=8)
FLAGSHIP = dict(kv_quant="int8c4p", weight_quant="int8")
BATCH = 2
TOL = 1e-4
# int8/int4 paths: a one-ulp difference in a K/V value or a projection
# output can move it by one quantisation level; see tests/test_torch_t5.py
TOL_QUANT = 2e-2


@pytest.fixture(scope="module")
def bundles():
    """(JAX bundle, port bundle): the tiny flagship in fp32 with identical
    weights; the JAX params carry its derived `qweights` collection."""
    jb = japi.init_model(model_cfg=JAX_FLAGSHIP.replace(**TINY), task=TASK,
                         compute_dtype="float32", **FLAGSHIP)
    pb = api.init_model(model_cfg=PERCEIVER_TF_MC13.replace(**TINY), task=TASK,
                        device="cpu", compute_dtype="float32", **FLAGSHIP)
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


def test_bridge_loads_strict_and_skips_qweights(bundles):
    jb, pb = bundles
    assert "qweights" in jb.params
    sd = state_dict_from_jax(numpy_params(jb.params))
    want = reference_style_state_dict(numpy_params(jb.params), prefix="")
    assert sorted(sd) == sorted(want) == sorted(pb.model.state_dict())
    for k, v in want.items():
        assert np.array_equal(sd[k].numpy(), v), k


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_decoder_weight_bytes_match_jax(bundles, mode):
    """The side-car weights of every decoder layer and the LM head equal
    JAX's quantize_decoder_weights: int8 values and scales, or bf16."""
    jb, pb = bundles
    q = jax_wq(jb.params, mode)["decoder"]["decoder"]
    model = YMT3(pb.cfg.replace(weight_quant=mode))
    model.load_state_dict(pb.model.state_dict(), strict=True)
    pairs = [(model.lm_head, q["lm_head"])]
    for i, blk in enumerate(model.decoder.block):
        sa, ca, ff = blk.layer
        layer = q[f"layer_{i}"]
        for n in "qkvo":
            pairs.append((getattr(sa.SelfAttention, n), layer["self_attn"][n]))
            pairs.append((getattr(ca.EncDecAttention, n), layer["cross_attn"][n]))
        for n in ("wi_0", "wi_1", "wo"):
            pairs.append((getattr(ff.DenseReluDense, n), layer["ff"][n]))
    quantized = [m for m in model.modules()
                 if isinstance(m, QuantDense) and m.weight_quant != "none"]
    assert len(pairs) == len(quantized) == 23
    for lin, ref in pairs:
        got = lin.weight_q.T.float().numpy()
        assert np.array_equal(got, np.asarray(ref["kernel_q"], np.float32))
        if mode == "int8":
            assert lin.weight_q.dtype == torch.int8
            assert np.array_equal(lin.weight_scale.numpy(),
                                  np.asarray(ref["kernel_scale"]))
        else:
            assert lin.weight_q.dtype == torch.bfloat16
            assert "weight_scale" not in lin._buffers
    # the encoder side keeps its fp32 master only
    assert all(m.weight_quant == "none" for m in model.encoder.modules()
               if isinstance(m, QuantDense))


def test_conv_pre_encoder_matches_jax(bundles):
    jb, pb = bundles
    feats = np.random.default_rng(0).standard_normal((2, 16, 512)).astype(np.float32)
    want = JaxConvPreEncoder(channels=TINY["conv_channels"], dtype=jnp.float32).apply(
        {"params": jb.params["params"]["encoder"]["conv_pre"]}, jnp.asarray(feats))
    with torch.no_grad():
        got = pb.model.encoder.pre_encoder(torch.from_numpy(feats))
    assert got.shape == (2, 16, 64, TINY["conv_channels"])
    assert np.abs(got.numpy() - np.asarray(want)).max() < TOL


def test_encoder_and_memory_match_jax(bundles, song, jax_memory):
    """The Perceiver-TF output (fp32) within TOL; the bf16 memory after the
    group projection within one bf16 ulp of each entry, the ulp taken at
    magnitude 1 or more (the projection sums products of order-1 inputs, so
    a rounding difference there is absolute near zero)."""
    jb, pb = bundles
    feats = jb.frontend(jnp.asarray(song[0]))
    enc_j = jb.model.apply(jb.params, feats, method=lambda m, f: m.encoder(f))
    with torch.no_grad():
        enc_p = pb.model.encoder(pb.frontend(torch.from_numpy(song[0])))
        mem_p = api._encode_batch(pb, song[0])
    assert enc_p.shape == (BATCH, 256, 26, TINY["ptf_d_latent"])
    assert np.abs(enc_p.numpy() - np.asarray(enc_j)).max() < TOL
    assert mem_p.dtype == torch.bfloat16 and jax_memory.dtype == jnp.bfloat16
    assert mem_p.shape == (BATCH, 13, 256, TINY["d_model"])
    a, b = _to_torch(jax_memory).numpy(), mem_p.float().numpy()
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert (np.abs(a - b) <= ulp).all()
    print(f"memory: {(a != b).mean():.2%} of entries differ, max "
          f"{np.abs(a - b).max():.4f}")


@pytest.fixture(scope="module")
def token_path(bundles, jax_memory):
    """JAX's greedy tokens for the flagship config, from its memory."""
    jb, pb = bundles
    L = pb.task_manager.max_token_length
    prefix = pb.task_manager.subtask_prefix_ids()
    cross = japi._cross_kv_batch(jb.model, jb.params, jax_memory)
    ids = np.asarray(japi._decode_batch(
        jb.model, jb.params, jax_memory, cross, L,
        jnp.asarray(prefix, jnp.int32) if prefix else None))
    ids = ids.reshape(-1, L)  # channels folded into streams, as decoded
    return np.concatenate([np.zeros((ids.shape[0], 1), np.int32), ids], 1)


@pytest.mark.parametrize("overrides", [
    FLAGSHIP,
    dict(FLAGSHIP, use_pallas_decode=True),
    {"kv_quant": "int8c4"},
    {"kv_quant": "int4"},
], ids=["int8c4p-w8", "int8c4p-paged-w8", "int8c4", "int4"])
def test_decode_step_logits_follow_jax(bundles, jax_memory, token_path,
                                       overrides):
    """Per-step logits along JAX's flagship token path, both sides on
    JAX's memory: int8 dense or paged self cache, int4 cross K/V through
    the kernel's plain version (int8c4p) or the dense int4 product, int8
    decoder weights or none."""
    jb, pb = bundles
    steps = 64
    cfg = {"kv_quant": "none", "weight_quant": "none", **overrides}
    jm = JaxYMT3(jb.cfg.replace(**cfg))
    params = jb.params if cfg["weight_quant"] != "none" else {
        "params": jb.params["params"]}
    jstep = jax.jit(functools.partial(jm.apply, method=JaxYMT3.decode_step))
    pm = YMT3(pb.cfg.replace(**cfg))
    pm.load_state_dict(pb.model.state_dict(), strict=True)
    pm.eval()
    S, L = token_path.shape[0], pb.task_manager.max_token_length
    cross_j = jm.apply(params, jax_memory, method=JaxYMT3.init_cross_kv)
    kv_j = jm.empty_self_kvs(S, L)
    launches = int4_cross_attention.launches
    worst = same = 0.0
    with torch.no_grad():
        cross_p = pm.init_cross_kv(_to_torch(jax_memory))
        for cj, cp in zip(jax.tree_util.tree_leaves(cross_j),
                          jax.tree_util.tree_leaves(cross_p)):
            assert tuple(cj.shape) == tuple(cp.shape)
        kv_p = pm.empty_self_kvs(S, L)
        for pos in range(steps):
            tok = token_path[:, pos:pos + 1]
            lj, kv_j = jstep(params, jnp.asarray(tok),
                             jnp.asarray(pos, jnp.int32), kv_j, cross_j)
            lp, kv_p = pm.decode_step(torch.from_numpy(tok).long(), pos,
                                      kv_p, cross_p)
            worst = max(worst, float(np.abs(lp.numpy() - np.asarray(lj)).max()))
            same += float((lp.argmax(-1).numpy() == token_path[:, pos + 1]).mean())
    assert int4_cross_attention.launches == launches  # CPU: plain version
    print(f"{overrides}: {steps} steps, max |logit diff| {worst:.2e}, "
          f"greedy tokens equal to the flagship path {same / steps:.1%}")
    assert worst < TOL_QUANT


def test_flagship_transcription_matches_jax(bundles, song, jax_memory,
                                            monkeypatch):
    """The slice as a whole, from JAX's memory: identical greedy token
    ids, then identical notes and error counts (every field) from
    transcribe_segments_array with the beam-2 repair."""
    jb, pb = bundles
    segments, starts = song
    L = pb.task_manager.max_token_length
    prefix = pb.task_manager.subtask_prefix_ids()
    jprefix = jnp.asarray(prefix, jnp.int32) if prefix else None
    ids_j = np.asarray(japi._decode_batch(
        jb.model, jb.params, jax_memory,
        japi._cross_kv_batch(jb.model, jb.params, jax_memory), L, jprefix))
    beam_j = np.asarray(japi._decode_batch_beam(jb.model, jb.params,
                                                jax_memory, L, jprefix, 2))
    mem = _to_torch(jax_memory).to(torch.bfloat16)
    with torch.no_grad():
        ids_p = greedy_decode(pb.model, mem, L, prefix_ids=prefix).numpy()
        beam_p = beam_decode(pb.model, mem, L, beam_size=2,
                             prefix_ids=prefix).numpy()
    np.testing.assert_array_equal(ids_p, ids_j)
    # beam-2 ids can part at near-ties of the cumulative scores (see
    # test_beam_choices_follow_jax); the notes below still agree
    same = (beam_p == beam_j).all(axis=-1)
    print(f"beam-2: {same.sum()} of {same.size} streams identical")

    def jax_memory_of(bundle, audio):  # the port decodes JAX's memory
        return _to_torch(japi._encode_batch(jb.model, jb.params, jb.frontend,
                                            jnp.asarray(audio))).to(torch.bfloat16)

    monkeypatch.setattr(api, "_encode_batch", jax_memory_of)
    notes_j, err_j = japi.transcribe_segments_array(
        jb, segments, starts, batch_size=BATCH, repair_beam=2)
    steps, launches = beam_decode.steps, int4_cross_attention.launches
    notes_p, err_p = api.transcribe_segments_array(
        pb, segments, starts, batch_size=BATCH, repair_beam=2)
    assert beam_decode.steps > steps  # the detokenizer flagged a segment
    assert int4_cross_attention.launches == launches
    assert [dataclasses.astuple(n) for n in notes_p] == \
        [dataclasses.astuple(n) for n in notes_j]
    assert len(notes_p) > 0
    # both detokenize on their fast paths by default: every error count of
    # the transcription is JAX's; the Python walks agree with each other
    assert dataclasses.astuple(err_p) == dataclasses.astuple(err_j)
    assert err_p.total() > 0
    _, err_walk = jb.task_manager.detokenize_song(ids_j, starts, fast=False)
    _, err_port = pb.task_manager.detokenize_song(ids_p, starts, fast=False)
    assert dataclasses.astuple(err_port) == dataclasses.astuple(err_walk)


# a beam decision whose two candidates' cumulative log-probabilities lie
# closer than this is a tie at the precision the two frameworks share:
# the scores reach about -100 (fp32 ulp 7.6e-6) and each step's log-softmax
# differs by ~1e-6 between JAX's and PyTorch's exp/log
BEAM_TIE = 1e-4


def test_beam_choices_follow_jax(bundles, jax_memory):
    """Beam-2 driven step by step along the reference's own choices: at
    every step the port's logits stay within TOL_QUANT of JAX's, and its
    two surviving (parent, token) candidates are JAX's wherever JAX's
    second and third candidates are more than BEAM_TIE apart."""
    jb, pb = bundles
    K, L, V = 2, pb.task_manager.max_token_length, jb.cfg.vocab_size
    mem = jax_memory.reshape(-1, *jax_memory.shape[2:])
    S = mem.shape[0]
    mem_beam = jnp.repeat(mem, K, axis=0)[:, None]
    jstep = jax.jit(functools.partial(jb.model.apply, method=JaxYMT3.decode_step))
    cross_j = jb.model.apply(jb.params, mem_beam, method=JaxYMT3.init_cross_kv)
    kv_j = jb.model.empty_self_kvs(S * K, L)
    buf = np.zeros((S, K, L + 1), np.int64)
    scores = np.zeros((S, K), np.float32)
    done = np.zeros((S, K), bool)
    pad_only = np.full(V, -1e9, np.float32)
    pad_only[0] = 0.0

    def candidates(logits, pos):
        logp = logits.reshape(S, K, V)
        logp = np.where(done[:, :, None], pad_only, logp)
        if pos == 0:
            logp = logp + np.array([0.0, -1e9], np.float32)[None, :, None]
        cand = (scores[:, :, None] + logp).reshape(S, K * V)
        return cand, np.argsort(-cand, axis=1, kind="stable")[:, :K + 1]

    worst, ties, decisions = 0.0, 0, 0
    with torch.no_grad():
        cross_p = pb.model.init_cross_kv(_to_torch(mem_beam))
        kv_p = pb.model.empty_self_kvs(S * K, L)
        for pos in range(L):
            if done.all():
                break
            tok = buf[:, :, pos].reshape(S * K, 1)
            lj, kv_j = jstep(jb.params, jnp.asarray(tok, jnp.int32),
                             jnp.asarray(pos, jnp.int32), kv_j, cross_j)
            lp, kv_p = pb.model.decode_step(torch.from_numpy(tok), pos, kv_p,
                                            cross_p)
            worst = max(worst, float(np.abs(lp.numpy() - np.asarray(lj)).max()))
            cj, oj = candidates(np.asarray(jax.nn.log_softmax(lj, -1)), pos)
            cp, op = candidates(torch.log_softmax(lp, -1).numpy(), pos)
            live = ~done.all(axis=1)
            margin = (np.take_along_axis(cj, oj[:, K - 1:K], 1)
                      - np.take_along_axis(cj, oj[:, K:], 1))[:, 0]
            clear = live & (margin > BEAM_TIE)
            agree = np.sort(oj[:, :K], 1) == np.sort(op[:, :K], 1)
            assert agree[clear].all(), (pos, np.nonzero(clear & ~agree.all(1)))
            decisions += int(live.sum())
            ties += int((live & ~clear).sum())
            top = oj[:, :K]
            parent, token = top // V, top % V
            flat = (np.arange(S)[:, None] * K + parent).reshape(-1)
            kv_j = jax.tree_util.tree_map(lambda x: x[jnp.asarray(flat)], kv_j)
            kv_p = pb.model.decoder.self_cache.reorder(kv_p, torch.from_numpy(flat))
            buf = np.take_along_axis(buf, parent[:, :, None], 1)
            buf[:, :, pos + 1] = token
            done = np.take_along_axis(done, parent, 1) | (token == EOS_ID)
            scores = np.take_along_axis(cj, top, 1)
    print(f"beam-2 stepwise: {decisions} decisions, {ties} within "
          f"{BEAM_TIE}, max |logit diff| {worst:.2e}")
    assert worst < TOL_QUANT
    assert ties < 0.01 * decisions


def test_api_transcribe_writes_midi(bundles, song, tmp_path):
    """The public entry on the CPU: audio file → MIDI through the plain
    versions (no kernel launch)."""
    from yourmt3_tpu_torch.data.audio_io import write_wav
    from yourmt3_tpu_torch.tokens.midi_io import midi2note
    _, pb = bundles
    wav = tmp_path / "song.wav"
    write_wav(str(wav), sine_song(4.0), pb.audio_cfg.sample_rate)
    launches = int4_cross_attention.launches
    out = api.transcribe(pb, str(wav), str(tmp_path / "song.mid"),
                         batch_size=BATCH)
    assert int4_cross_attention.launches == launches
    assert len(midi2note(out)) > 0


def test_full_width_flagship_builds_and_steps():
    """perceiver_tf_mc13 at its published width with int8c4p and int8
    decoder weights: builds on the CPU and runs one decode step of the 13
    channels on the int4 cross path."""
    b = api.init_model("perceiver_tf_mc13", TASK, device="cpu", **FLAGSHIP)
    m = b.model
    assert isinstance(m.encoder.pre_encoder.block[0].conv_down, torch.nn.Conv2d)
    assert m.projection.group_proj.weight.shape == (512, 2 * 128)
    quantized = [x for x in m.modules()
                 if isinstance(x, QuantDense) and x.weight_quant == "int8"]
    assert len(quantized) == 8 * 11 + 1
    mem = torch.randn(1, 13, 256, 512, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        cross = m.init_cross_kv(mem.to(torch.bfloat16))
        (k4, ks), _ = cross[0]
        assert k4.shape == (13, 6, 32, 256) and k4.dtype == torch.uint8
        kv = m.empty_self_kvs(13, 256)
        assert kv[0][0][0].dtype == torch.int8
        logits, _ = m.decode_step(torch.zeros((13, 1), dtype=torch.long), 0,
                                  kv, cross)
    assert logits.shape == (13, b.cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


def test_projection_of_jax_encoder_output_matches_jax_memory(bundles, song):
    """Where the memory's one-ulp differences come from: fed the same
    Perceiver-TF output, the port's bf16 group projection and JAX's agree
    in all but a few entries (under 0.05 %), each within one bf16 ulp. The
    ~0.5 % that differ end to end come from the bf16 cast of Perceiver
    outputs that differ by up to ~4e-5; JAX's own jitted and eager
    encoders differ by ~2e-6, which alone moves ~0.1 % of the entries."""
    jb, pb = bundles
    feats = jb.frontend(jnp.asarray(song[0]))
    enc_j = jb.model.apply(jb.params, feats, method=lambda m, f: m.encoder(f))
    mem_j = jb.model.apply(jb.params, enc_j, method=lambda m, e: m.projection(e))
    with torch.no_grad():
        mem_p = pb.model.projection(_to_torch(enc_j))
    assert mem_p.dtype == torch.bfloat16 and mem_j.dtype == jnp.bfloat16
    assert mem_p.shape == mem_j.shape == (BATCH, 13, 256, TINY["d_model"])
    a, b = _to_torch(mem_j).numpy(), mem_p.float().numpy()
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert (np.abs(a - b) <= ulp).all()
    differ = (a != b).mean()
    print(f"memory from JAX's encoder output: {differ:.4%} of entries differ")
    assert differ < 5e-4, differ
