"""The port's transcription slice as a whole against the JAX package:
t5_tiny with mt3_full_plus_256 in fp32, weights bridged from JAX, on a
two-segment sine song."""

import dataclasses
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import yourmt3_tpu.api as japi
from yourmt3_tpu.models.decoding import beam_decode as jax_beam_decode
from yourmt3_tpu.models.decoding import greedy_decode as jax_greedy_decode
from yourmt3_tpu.models.ymt3 import YMT3 as JaxYMT3
from yourmt3_tpu_torch import api
from yourmt3_tpu_torch.data.audio_io import slice_padded_array
from yourmt3_tpu_torch.models.decoding import beam_decode, greedy_decode
from yourmt3_tpu_torch.ops.decode_attention import paged_decode_attention

from torch_port_util import bridged_bundles, sine_song

BATCH = 2
# int8 paths: a one-ulp difference in a K/V value can move it by one int8
# level (scale/127 of its row); see tests/test_torch_t5.py
TOL_INT8 = 2e-2


@pytest.fixture(scope="module")
def bundles():
    return bridged_bundles("t5_tiny", "mt3_full_plus_256",
                           use_pallas_decode=True)


@pytest.fixture(scope="module")
def song(bundles):
    ac = bundles[1].audio_cfg
    segments, starts = slice_padded_array(sine_song(4.0), ac.input_frames)
    assert segments.shape[0] == 2
    return segments, (starts / ac.sample_rate).tolist()


def _memories(jb, pb, chunk):
    mem_j = japi._encode_batch(jb.model, jb.params, jb.frontend,
                               jnp.asarray(chunk))
    with torch.no_grad():
        mem_p = api._encode_batch(pb, chunk)
    assert np.abs(mem_p.numpy() - np.asarray(mem_j)).max() < 1e-4
    return mem_j, mem_p


def test_paged_transcription_matches_jax(bundles, song):
    """Identical greedy and beam-repair token ids, notes and error counts
    on the paged (unquantised) decode path."""
    jb, pb = bundles
    segments, starts = song
    L = pb.task_manager.max_token_length
    prefix = pb.task_manager.subtask_prefix_ids()
    mem_j, mem_p = _memories(jb, pb, segments)
    cross_j = japi._cross_kv_batch(jb.model, jb.params, mem_j)
    ids_j = np.asarray(japi._decode_batch(jb.model, jb.params, mem_j, cross_j,
                                          L, jnp.asarray(prefix, jnp.int32)))
    with torch.no_grad():
        ids_p = greedy_decode(pb.model, mem_p, L, prefix_ids=prefix).numpy()
    np.testing.assert_array_equal(ids_p, ids_j)
    beam_j = np.asarray(japi._decode_batch_beam(
        jb.model, jb.params, mem_j, L, jnp.asarray(prefix, jnp.int32), 2))
    with torch.no_grad():
        beam_p = beam_decode(pb.model, mem_p, L, beam_size=2,
                             prefix_ids=prefix).numpy()
    np.testing.assert_array_equal(beam_p, beam_j)

    notes_j, err_j = japi.transcribe_segments_array(
        jb, segments, starts, batch_size=BATCH, repair_beam=2)
    steps = beam_decode.steps
    notes_p, err_p = api.transcribe_segments_array(
        pb, segments, starts, batch_size=BATCH, repair_beam=2)
    assert beam_decode.steps > steps  # the detokenizer flagged a segment
    assert [dataclasses.astuple(n) for n in notes_p] == \
        [dataclasses.astuple(n) for n in notes_j]
    # both detokenize on their fast paths by default: every error count of
    # the transcription is JAX's; the Python walks agree with each other
    assert dataclasses.astuple(err_p) == dataclasses.astuple(err_j)
    assert err_p.total() > 0
    _, err_walk = jb.task_manager.detokenize_song(ids_j, starts, fast=False)
    _, err_port = pb.task_manager.detokenize_song(ids_p, starts, fast=False)
    assert dataclasses.astuple(err_port) == dataclasses.astuple(err_walk)


def test_int8_paged_logits_follow_jax(bundles, song):
    """kv_quant="int8" with the paged kernel (what --decode-path fast
    picks at L = 1024): per-step logits along JAX's own greedy token path
    stay within TOL_INT8; the share of identical greedy tokens is reported."""
    jb, pb = bundles
    ov = dict(kv_quant="int8", use_pallas_decode=True)
    jm = JaxYMT3(jb.cfg.replace(**ov))
    pb = dataclasses.replace(pb).with_decode_overrides(**ov)
    segments, _ = song
    L = pb.task_manager.max_token_length
    prefix = pb.task_manager.subtask_prefix_ids()
    mem_j, mem_p = _memories(jb, pb, segments)
    cross_j = jm.apply(jb.params, mem_j, method=JaxYMT3.init_cross_kv)
    ids_j = np.asarray(jax_greedy_decode(jm, jb.params, mem_j, L,
                                         jnp.asarray(prefix, jnp.int32),
                                         cross_kvs=cross_j))[:, 0]
    steps = int((ids_j != 0).sum(axis=1).max()) + 1
    path = np.concatenate([np.zeros((2, 1), np.int32), ids_j], axis=1)

    jstep = jax.jit(functools.partial(jm.apply, method=JaxYMT3.decode_step))
    kv_j = jm.empty_self_kvs(2, L)
    launches = paged_decode_attention.launches
    with torch.no_grad():
        cross_p = pb.model.init_cross_kv(mem_p)
        kv_p = pb.model.empty_self_kvs(2, L)
        same = worst = 0.0
        for pos in range(min(steps, L)):
            tok = path[:, pos:pos + 1]
            lj, kv_j = jstep(jb.params, jnp.asarray(tok),
                             jnp.asarray(pos, jnp.int32), kv_j, cross_j)
            lp, kv_p = pb.model.decode_step(torch.from_numpy(tok).long(), pos,
                                            kv_p, cross_p)
            worst = max(worst, float(np.abs(lp.numpy() - np.asarray(lj)).max()))
            same += float((lp.argmax(-1).numpy() == path[:, pos + 1]).mean())
    assert paged_decode_attention.launches == launches  # CPU: plain version
    print(f"int8 paged: {steps} steps, max |logit diff| {worst:.2e}, "
          f"identical greedy tokens {same / steps:.1%}")
    assert worst < TOL_INT8


@pytest.mark.parametrize("guard", [0, 3])
def test_greedy_and_beam_tokens_match_jax_dense(bundles, song, guard):
    jb, pb = bundles
    jm = JaxYMT3(jb.cfg.replace(use_pallas_decode=False))
    pm = dataclasses.replace(pb).with_decode_overrides(use_pallas_decode=False)
    L = pb.task_manager.max_token_length
    prefix = pb.task_manager.subtask_prefix_ids()
    mem_j, mem_p = _memories(jb, pm, song[0])
    want = np.asarray(jax_greedy_decode(
        jm, jb.params, mem_j, L, jnp.asarray(prefix, jnp.int32),
        repetition_guard=guard))
    with torch.no_grad():
        got = greedy_decode(pm.model, mem_p, L, prefix_ids=prefix,
                            repetition_guard=guard, unroll=4).numpy()
    np.testing.assert_array_equal(got, want)
    if guard:
        return
    want = np.asarray(jax_beam_decode(jm, jb.params, mem_j, L, beam_size=2,
                                      prefix_ids=jnp.asarray(prefix, jnp.int32)))
    with torch.no_grad():
        got = beam_decode(pm.model, mem_p, L, beam_size=2,
                          prefix_ids=prefix).numpy()
    np.testing.assert_array_equal(got, want)
