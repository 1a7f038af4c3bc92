"""The decode step with the position on the device, and the decode loops
that replay it as a CUDA graph (models/decoding.py).

On the CPU: `YMT3.decode_step` gives bit-identical logits and self caches
with the position as a host int and as a 0-dim tensor on every dense
self-cache path, for the single- and the multi-channel decoder; the CPU
decode loops never capture. On the card (marker `cuda`, skipped without
one): the flagship's graphed greedy and beam decodes against the eager
route of the same loops. The file imports nothing of JAX, so on a machine
without it run the card's tests with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_decode_graph.py
"""

import numpy as np
import pytest
import torch

from yourmt3_tpu_torch import api
from yourmt3_tpu_torch.config.model import PERCEIVER_TF_MC13, T5_TINY
from yourmt3_tpu_torch.models import decoding
from yourmt3_tpu_torch.ops import int4_cross_attention as ia
from yourmt3_tpu_torch.utils import profiling

KV_QUANTS = ("none", "int8", "int8c4", "int8c4p", "int4")
TINY_MC = dict(d_model=64, d_kv=16, num_heads=4, d_ff=128, num_decoder_layers=2,
               ptf_d_latent=64, ptf_num_blocks=1, conv_channels=8)
DECODERS = {  # name → (model config, task)
    "t5": (T5_TINY, "mt3_full_plus"),
    "multi_channel": (PERCEIVER_TF_MC13.replace(**TINY_MC), "mc13_full_plus_256"),
    "multi_channel_gqa": (PERCEIVER_TF_MC13.replace(decoder_kv_heads=2, **TINY_MC),
                          "mc13_full_plus_256"),
}
CASES = [(d, q) for d in ("t5", "multi_channel") for q in KV_QUANTS] + [
    ("multi_channel_gqa", "none"), ("multi_channel_gqa", "int8")]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Decode loops of tiny ops: one intra-op thread, so that the parallel
    run's workers do not wait on each other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph_counts():
    got = profiling.counters()
    return got["decode.graph_captures"], got["decode.graph_replays"]


def _memory(model, batch, frames, seed, dev="cpu"):
    gen = torch.Generator().manual_seed(seed)
    C = model.cfg.num_channels if model.multi else 1
    mem = torch.randn(batch, C, frames, model.cfg.d_model, generator=gen)
    return mem.to(dev, model.dtype)


@pytest.mark.parametrize("decoder,kv_quant", CASES,
                         ids=[f"{d}-{q}" for d, q in CASES])
def test_decode_step_with_a_device_position_is_bit_identical(decoder, kv_quant):
    """The same steps with `pos` as a host int and as a 0-dim int64 tensor,
    on two copies of the caches, at a read horizon of half the caches
    (phases) and then the whole: equal logits and caches, bit for bit."""
    cfg, task = DECODERS[decoder]
    model = api.init_model(model_cfg=cfg, task=task, device="cpu", seed=3,
                           kv_quant=kv_quant, weight_quant="int8").model
    L, streams = 16, (2 * cfg.num_channels if model.multi else 2)
    with torch.no_grad():
        cross = model.init_cross_kv(_memory(model, 2, 12, 4))
        kvs = {"int": model.empty_self_kvs(streams, L, "cpu"),
               "tensor": model.empty_self_kvs(streams, L, "cpu")}
        gen = torch.Generator().manual_seed(5)
        for pos in range(12):
            tok = torch.randint(2, model.cfg.vocab_size, (streams, 1), generator=gen)
            kv_len = L // 2 if pos < L // 2 else 0
            got = {}
            for kind, p in (("int", pos), ("tensor", torch.tensor(pos))):
                logits, kvs[kind] = model.decode_step(tok, p, kvs[kind], cross,
                                                      kv_len=kv_len)
                got[kind] = logits
            assert torch.equal(got["int"], got["tensor"]), pos
            for a, b in zip(_tensors(kvs["int"]), _tensors(kvs["tensor"])):
                assert torch.equal(a, b), pos


def _tensors(kvs):
    if isinstance(kvs, (list, tuple)):
        for x in kvs:
            yield from _tensors(x)
    else:
        yield kvs


def test_cpu_decode_loops_never_capture():
    """greedy_decode (forced prefix, repetition guard, two phases) and
    beam_decode on the CPU take the eager step: no capture, no replay, and
    every step counted."""
    cfg, task = DECODERS["t5"]
    model = api.init_model(model_cfg=cfg, task=task, device="cpu", seed=1,
                           kv_quant="int8").model
    memory = _memory(model, 2, 12, 2)
    before = _graph_counts()
    g0, b0 = decoding.greedy_decode.steps, decoding.beam_decode.steps
    with torch.no_grad():
        ids = decoding.greedy_decode(model, memory, 16, prefix_ids=[5, 6],
                                     ban_eos=True, phases=2, repetition_guard=3)
        beams = decoding.beam_decode(model, memory, 16, beam_size=2,
                                     prefix_ids=[5, 6])
    assert ids.shape == beams.shape == (2, 1, 16)
    assert ids[:, 0, :2].tolist() == [[5, 6], [5, 6]]
    assert decoding.greedy_decode.steps - g0 == 16
    assert decoding.beam_decode.steps - b0 > 2
    assert _graph_counts() == before


# ---------------------------------------------------------------------------
# on the card: the flagship, graphed against eager
# ---------------------------------------------------------------------------

L_FLAGSHIP, BATCH = 256, 8  # 8 segments × 13 channels = 104 streams
GREEDY_CASES = {  # name → greedy_decode keywords
    "prefix": dict(prefix_ids=[3, 4, 5]),
    "ban_eos": dict(ban_eos=True),
    "repetition_guard": dict(prefix_ids=[3], repetition_guard=4),
    "phases": dict(phases=2, ban_eos=True),
}


@pytest.fixture(scope="module")
def flagship():
    """The flagship at full width with seeded random weights, int8c4p
    caches and int8 decoder weights, and the memory of 8 noise segments."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bundle = api.init_model("perceiver_tf_mc13", "mc13_full_plus_256", device="cuda",
                            seed=0, kv_quant="int8c4p", weight_quant="int8")
    audio = np.random.default_rng(0).normal(
        0.0, 0.1, (BATCH, bundle.audio_cfg.input_frames)).astype(np.float32)
    with torch.no_grad():
        memory = api._encode_batch(bundle, audio)
    return bundle.model, memory


def _decode_counted(fn, model, memory, **kw):
    """→ (ids on the host, steps, int4 launches, captures, replays, peak
    bytes above the call's start)."""
    steps = decoding.beam_decode if "beam_size" in kw else decoding.greedy_decode
    s0, l0, (c0, r0) = steps.steps, ia.int4_cross_attention.launches, _graph_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        ids = fn(model, memory, L_FLAGSHIP, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    c1, r1 = _graph_counts()
    return (ids.cpu(), steps.steps - s0, ia.int4_cross_attention.launches - l0,
            c1 - c0, r1 - r0, peak)


def _eager(monkeypatch):
    monkeypatch.setattr(decoding, "_graphable", lambda *a: False)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_graphed_greedy_decode_matches_eager(flagship, monkeypatch, case):
    """104 streams, L = 256: the graphed loop's token ids equal the eager
    loop's; one capture per phase, a replay for every step past the eager
    ones (the forced prefix, or position 0), 8 int4 launches a step on
    both routes, and one `decode.step` span a step."""
    model, memory = flagship
    kw = GREEDY_CASES[case]
    layers = model.cfg.num_decoder_layers
    profiling.clear()
    profiling.enable()
    try:
        ids, steps, launches, captures, replays, _ = _decode_counted(
            decoding.greedy_decode, model, memory, **kw)
        spans = [sp.name for sp in profiling.spans()]
    finally:
        profiling.disable()
        profiling.clear()
    eager_steps = max(len(kw.get("prefix_ids", [])), 1)
    phases = kw.get("phases", 1)
    assert steps > eager_steps
    assert (captures, replays) == (phases, steps - eager_steps)
    assert launches == layers * steps
    assert spans.count("decode.step") == steps
    assert spans.count("decode.capture") == phases
    if kw.get("ban_eos"):
        assert steps == L_FLAGSHIP
    _eager(monkeypatch)
    want, e_steps, e_launches, e_captures, _, _ = _decode_counted(
        decoding.greedy_decode, model, memory, **kw)
    assert (e_steps, e_launches, e_captures) == (steps, layers * steps, 0)
    assert torch.equal(ids, want)


@pytest.mark.cuda
def test_graphed_beam_decode_matches_eager(flagship, monkeypatch):
    """Beam 2 over 208 streams, L = 256: equal token ids, one capture and a
    replay for every step past the first, 8 int4 launches a step, and a
    peak of allocated memory no higher than the eager loop's."""
    model, memory = flagship
    layers = model.cfg.num_decoder_layers
    ids, steps, launches, captures, replays, peak = _decode_counted(
        decoding.beam_decode, model, memory, beam_size=2, prefix_ids=[3])
    assert steps > 1
    assert (captures, replays) == (1, steps - 1)
    assert launches == layers * steps
    _eager(monkeypatch)
    want, e_steps, e_launches, e_captures, _, e_peak = _decode_counted(
        decoding.beam_decode, model, memory, beam_size=2, prefix_ids=[3])
    assert (e_steps, e_launches, e_captures) == (steps, layers * steps, 0)
    assert torch.equal(ids, want)
    assert peak <= e_peak, (peak, e_peak)
