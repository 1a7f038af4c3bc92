"""Early-exit decode with stream compaction
(models/decoding.greedy_decode_early_exit): the port's tokens equal its
plain greedy decode's (itself held to JAX) on every self-cache layout,
the JAX package's early-exit tokens on bridged weights, and the API
keeps JAX's argument checks.

Untrained tiny models rarely emit EOS, so the decodes stop at a token
that the plain decode emits in most streams at different steps (the stop
token is an argument of both decoders); with 16 streams, chunk=4 and
compact_threshold=1.0 the batch then shrinks while streams still run.
"""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yourmt3_tpu.config.model import T5_TINY as JAX_T5_TINY
from yourmt3_tpu.models.decoding import \
    greedy_decode_early_exit as jax_greedy_decode_early_exit
from yourmt3_tpu.models.ymt3 import YMT3 as JaxYMT3
from yourmt3_tpu_torch import api
from yourmt3_tpu_torch.config.model import T5_TINY
from yourmt3_tpu_torch.models import kv_cache
from yourmt3_tpu_torch.models.decoding import (greedy_decode,
                                               greedy_decode_early_exit)
from yourmt3_tpu_torch.models.ymt3 import YMT3
from yourmt3_tpu_torch.weights import state_dict_from_jax

from torch_port_util import numpy_params, one_intra_op_thread  # noqa: F401

TINY = dict(vocab_size=600, d_kv=16, num_heads=4, compute_dtype="float32")
STREAMS, FRAMES, FEATURES = 16, 16, 24
PREFIX = [5, 7]
L = 48


@pytest.fixture(scope="module")
def feats():
    return np.random.default_rng(0).standard_normal(
        (STREAMS, FRAMES, FEATURES)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_params(feats):
    model = JaxYMT3(JAX_T5_TINY.replace(**TINY))
    return model.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                      jnp.zeros((STREAMS, 1, 8), jnp.int32))


def _port_model(jax_params, **cfg):
    model = YMT3(T5_TINY.replace(**TINY, **cfg), FEATURES).eval()
    model.load_state_dict(state_dict_from_jax(numpy_params(jax_params)),
                          strict=True)
    return model


def _stop_token(ids):
    """A token that most streams emit after the prefix, not all at the
    same step: the decodes stop there, at different steps per stream."""
    rows = ids.reshape(-1, ids.shape[-1])[:, len(PREFIX):]
    counts = collections.Counter(t for r in rows for t in set(r.tolist()))
    for tok, _ in counts.most_common():
        if tok in PREFIX:
            continue
        first = {int(np.argmax(r == tok)) for r in rows if (r == tok).any()}
        if len(first) > 2:
            return int(tok)
    raise AssertionError("no token stops the streams at different steps")


@pytest.fixture
def gathered(monkeypatch):
    """Record the row count of every compaction's gather (the self and
    the cross caches' layouts)."""
    sizes = []
    gather = kv_cache._Layout.reorder

    def recording(layout, kvs, idx):
        sizes.append(int(idx.shape[0]))
        return gather(layout, kvs, idx)

    monkeypatch.setattr(kv_cache._Layout, "reorder", recording)
    return sizes


CASES = {"dense": {}, "paged": {"use_pallas_decode": True},
         "int8": {"kv_quant": "int8"},
         "int8_paged": {"kv_quant": "int8", "use_pallas_decode": True},
         "int4": {"kv_quant": "int4"}, "int8c4p": {"kv_quant": "int8c4p"}}


@pytest.mark.parametrize("case", sorted(CASES))
def test_early_exit_matches_plain_greedy(jax_params, feats, gathered, case):
    """Identical tokens with compaction proven: at least one compaction,
    and the batch shrank below the stream count."""
    model = _port_model(jax_params, **CASES[case])
    with torch.no_grad():
        mem = model.encode(torch.from_numpy(feats))
        stop = _stop_token(greedy_decode(model, mem, L, prefix_ids=PREFIX).numpy())
        want = greedy_decode(model, mem, L, prefix_ids=PREFIX, eos_id=stop)
        before = greedy_decode_early_exit.compactions
        got = greedy_decode_early_exit(model, mem, L, prefix_ids=PREFIX,
                                       eos_id=stop, chunk=4,
                                       compact_threshold=1.0)
    lengths = (want[:, 0] != 0).sum(-1)
    assert len(set(lengths.tolist())) > 2, lengths  # streams end apart
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert greedy_decode_early_exit.compactions > before
    assert min(gathered) < STREAMS, gathered


def test_early_exit_matches_jax_early_exit(jax_params, feats):
    """The port's early exit against JAX's greedy_decode_early_exit on
    bridged weights, with the same stop token, chunk and threshold."""
    jm = JaxYMT3(JAX_T5_TINY.replace(**TINY))
    mem_j = jm.apply(jax_params, jnp.asarray(feats), method=JaxYMT3.encode)
    model = _port_model(jax_params)
    with torch.no_grad():
        mem = model.encode(torch.from_numpy(feats))
        stop = _stop_token(greedy_decode(model, mem, L, prefix_ids=PREFIX).numpy())
        got = greedy_decode_early_exit(model, mem, L, prefix_ids=PREFIX,
                                       eos_id=stop, chunk=4,
                                       compact_threshold=1.0).numpy()
    want = np.asarray(jax_greedy_decode_early_exit(
        jm, jax_params, mem_j, L, prefix_ids=jnp.asarray(PREFIX, jnp.int32),
        eos_id=stop, chunk=4, compact_threshold=1.0))
    np.testing.assert_array_equal(got, want)


def test_early_exit_through_the_api_matches_plain(monkeypatch):
    """api.transcribe_audio_array with early_exit=True gives the notes and
    errors of early_exit=False, and runs the early-exit decoder."""
    bundle = api.init_model("t5_tiny", "mt3_full_plus_256", device="cpu",
                            compute_dtype="float32", kv_quant="int8")
    audio = (np.random.default_rng(11).standard_normal(
        int(bundle.audio_cfg.input_frames * 2.5)) * 0.1).astype(np.float32)
    calls = []
    early = api.greedy_decode_early_exit

    def counting(*a, **kw):
        calls.append(1)
        return early(*a, **kw)

    monkeypatch.setattr(api, "greedy_decode_early_exit", counting)
    plain = api.transcribe_audio_array(bundle, audio, batch_size=2)
    assert not calls
    got = api.transcribe_audio_array(bundle, audio, batch_size=2,
                                     early_exit=True)
    assert len(calls) == 2  # one per batch of two segments
    assert got == plain


@pytest.mark.parametrize("kw", [dict(early_exit=True, beam_size=2),
                                dict(repetition_guard=3, beam_size=2),
                                dict(repetition_guard=3, early_exit=True)])
def test_api_rejects_what_jax_rejects(kw):
    bundle = api.init_model("t5_tiny", "mt3_full_plus_256", device="cpu")
    segments = np.zeros((1, bundle.audio_cfg.input_frames), np.float32)
    with pytest.raises(ValueError):
        api.transcribe_segments_array(bundle, segments, [0.0], **kw)
