"""The port's spans and counters (yourmt3_tpu_torch/utils/profiling.py), on
the CPU: what `span` costs and records, where the program opens its
spans, the counter registry, the idle-by-span reduction and the
operator's `--profile` switch."""

import collections
import glob
import os
import time
import types

import numpy as np
import pytest
import torch

from yourmt3_tpu_torch import api
from yourmt3_tpu_torch.cli import transcribe as cli_transcribe
from yourmt3_tpu_torch.config.audio import AudioConfig
from yourmt3_tpu_torch.data.audio_io import write_wav
from yourmt3_tpu_torch.models import decoding
from yourmt3_tpu_torch.ops import (decode_attention, fused_logmel,
                                   int4_cross_attention, kv_quant, launch_probe)
from yourmt3_tpu_torch.parallel import tensor_parallel
from yourmt3_tpu_torch.train import trainer
from yourmt3_tpu_torch.utils import profiling

SMALL = dict(input_frames=4095, n_fft=512, hop_length=128, n_mels=64)
TRAIN_CHILDREN = {"train.input", "train.frontend", "train.augment",
                  "train.forward", "train.backward", "train.optimizer"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Decode loops of tiny ops: one intra-op thread, as in the other
    decode tests, so that the parallel run's workers do not wait on each
    other's threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def recorded():
    """Recording on and an empty record for the test; off afterwards."""
    profiling.clear()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        profiling.clear()


def _boom(*args, **kwargs):
    raise AssertionError("called while recording is off")


def test_span_off_is_one_check_and_a_shared_noop(monkeypatch):
    profiling.disable()
    assert not profiling.recording()
    n = len(profiling.spans())
    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", _boom)
        m.setattr(torch.cuda, "Event", _boom)
        m.setattr(profiling, "Span", _boom)
        m.setattr(time, "time_ns", _boom)
        a = profiling.span("decode.step")
        b = profiling.span("train.forward", torch.device("cpu"))
        c = profiling.request("transcribe")
        with a, b, c:
            pass
    assert a is b is c is profiling._NOOP
    assert len(profiling.spans()) == n


def test_enabled_spans_nest_with_parent_request_and_host_clock(recorded):
    t_before = time.time_ns()
    with profiling.span("outer") as outer:
        with profiling.span("mid") as mid:
            with profiling.span("inner") as inner:
                pass
        with profiling.span("sibling") as sibling:
            pass
    with profiling.span("second_root") as root2:
        pass
    t_after = time.time_ns()
    got = {sp.name: sp for sp in profiling.spans()}
    assert list(got) == ["inner", "mid", "sibling", "outer", "second_root"]
    assert outer.parent is None and outer.request == outer.id
    assert mid.parent == outer.id and sibling.parent == outer.id
    assert inner.parent == mid.id
    assert {sp.request for sp in (mid, inner, sibling)} == {outer.id}
    assert root2.parent is None and root2.request == root2.id != outer.id
    assert t_before <= outer.t0_ns <= mid.t0_ns <= inner.t0_ns <= inner.t1_ns
    assert inner.t1_ns <= mid.t1_ns <= sibling.t0_ns <= sibling.t1_ns <= outer.t1_ns
    assert outer.t1_ns <= root2.t0_ns <= root2.t1_ns <= t_after
    assert all(sp.device_ms is None for sp in got.values())
    with profiling.span("x"):
        assert profiling.request("transcribe") is profiling._NOOP


def test_bound_drops_the_oldest_and_counts_them(recorded, monkeypatch):
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=4))
    for i in range(6):
        with profiling.span(f"s{i}"):
            pass
    assert [sp.name for sp in profiling.spans()] == ["s2", "s3", "s4", "s5"]
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_recording_turns_on_under_the_torch_profiler():
    profiling.disable()
    profiling.clear()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert profiling.recording()
        with profiling.span("under_profiler"):
            torch.ones(8) + 1
    assert not profiling.recording()
    assert [sp.name for sp in profiling.spans()] == ["under_profiler"]
    assert any(e.key == "under_profiler" for e in prof.key_averages())
    profiling.clear()


def test_t5_tiny_transcription_records_its_stages_in_one_request(recorded):
    bundle = api.init_model("t5_tiny", "mt3_full_plus_256", device="cpu", seed=3)
    rng = np.random.default_rng(0)
    segments = 0.1 * rng.standard_normal((2, bundle.audio_cfg.input_frames))
    steps0 = decoding.greedy_decode.steps + decoding.beam_decode.steps
    api.transcribe_segments_array(bundle, segments.astype(np.float32), [0.0, 2.048],
                                  batch_size=2, repair_beam=2)
    steps = decoding.greedy_decode.steps + decoding.beam_decode.steps - steps0
    got = profiling.spans()
    names = collections.Counter(sp.name for sp in got)
    roots = [sp for sp in got if sp.parent is None]
    assert [sp.name for sp in roots] == ["transcribe"]
    assert {sp.request for sp in got} == {roots[0].id}
    assert {"encode", "cross_kv", "decode.greedy", "decode.step",
            "decode.done_read", "detokenize"} <= set(names)
    assert names["decode.step"] == steps > 0
    if decoding.beam_decode.steps:  # random weights: the repair ran
        assert names["repair.scan"] == 1 and names["decode.beam"] == 1
    by_id = {sp.id: sp for sp in got}
    assert {by_id[sp.parent].name for sp in got if sp.name == "decode.step"} <= {
        "decode.greedy", "decode.beam"}


def test_two_train_steps_record_the_step_and_its_six_parts(recorded, monkeypatch):
    bundle = api.init_model("t5_tiny", "mt3_full_plus_256", device="cpu",
                            audio_cfg=AudioConfig(**SMALL))
    rng = np.random.default_rng(1)
    tm = bundle.task_manager
    batches = [{"audio": (0.1 * rng.standard_normal(
                    (2, bundle.audio_cfg.input_frames))).astype(np.float32),
                "labels": rng.integers(3, tm.vocab_size, (2, 1, tm.max_token_length),
                                       dtype=np.int32)} for _ in range(2)]
    logged = []
    clock = iter([100.0, 110.0, 111.0])  # loop start, log at step 1, at step 2
    monkeypatch.setattr(trainer, "time", types.SimpleNamespace(
        perf_counter=lambda: next(clock), time=time.time))
    logger = types.SimpleNamespace(log=lambda step, m, prefix="": logged.append(m),
                                   close=lambda: None)
    trainer.train(bundle, iter(batches), total_steps=2, log_every=1, ckpt_every=0,
                  ckpt_dir="unused", warmup_steps=1, spec_augment=True,
                  logger=logger)
    got = profiling.spans()
    steps = [sp for sp in got if sp.name == "train.step"]
    assert len(steps) == 2 and all(sp.parent is None for sp in steps)
    for st in steps:
        kids = [sp for sp in got if sp.parent == st.id]
        assert {sp.name for sp in kids} == TRAIN_CHILDREN and len(kids) == 6
        assert all(sp.request == st.id for sp in kids)
    assert all(sp.device_ms is None for sp in got)
    assert sum(sp.name == "train.log" for sp in got) == 2
    # each logged rate covers the steps since the previous log
    assert [m["steps_per_sec"] for m in logged] == [pytest.approx(0.1), 1.0]
    tokens = [int((b["labels"] != 0).sum()) for b in batches]
    assert logged[1]["target_tokens_per_sec"] == pytest.approx(tokens[1])


def test_counters_are_the_attributes(monkeypatch):
    want = {}
    for i, (name, obj, attr) in enumerate([
            ("decode.greedy_steps", decoding.greedy_decode, "steps"),
            ("decode.beam_steps", decoding.beam_decode, "steps"),
            ("decode.early_exit_compactions", decoding.greedy_decode_early_exit,
             "compactions"),
            ("decode.graph_captures", decoding._Stepper, "captures"),
            ("decode.graph_replays", decoding._Stepper, "replays"),
            ("kernel.paged_decode_attention.launches",
             decode_attention.paged_decode_attention, "launches"),
            ("kernel.int4_cross_attention.launches",
             int4_cross_attention.int4_cross_attention, "launches"),
            ("kernel.int8_decode_attention.launches",
             kv_quant.int8_decode_attention, "launches"),
            ("kernel.fused_logmel.launches", fused_logmel.fused_logmel, "launches"),
            ("kernel.launch_probe.launches", launch_probe.launch_probe, "launches")]):
        monkeypatch.setattr(obj, attr, 1000 + i)
        want[name] = 1000 + i
    for i, kind in enumerate(("all_reduce", "all_gather", "bytes")):
        monkeypatch.setitem(tensor_parallel.traffic, kind, 7 + i)
        want["tp." + kind] = 7 + i
    assert profiling.counters() == want


def test_a_replay_advances_the_kernel_counters(monkeypatch):
    """`add_launches` moves the wrappers' attributes, so the registry, the
    benchmark and chip_smoke.py's launch checks count a CUDA graph's
    replayed launches too."""
    monkeypatch.setattr(int4_cross_attention.int4_cross_attention, "launches", 5)
    monkeypatch.setattr(fused_logmel.fused_logmel, "launches", 0)
    before = profiling.launches()
    assert before["int4_cross_attention"] == 5 and before["fused_logmel"] == 0
    profiling.add_launches({"int4_cross_attention": 8})
    profiling.add_launches({"int4_cross_attention": 8, "fused_logmel": 1})
    assert int4_cross_attention.int4_cross_attention.launches == 21
    got = profiling.counters()
    assert got["kernel.int4_cross_attention.launches"] == 21
    assert got["kernel.fused_logmel.launches"] == 1
    assert set(profiling.launches()) == {
        "paged_decode_attention", "int4_cross_attention", "int8_decode_attention",
        "fused_logmel", "launch_probe"}


def test_idle_by_span_on_synthetic_intervals():
    Sp = types.SimpleNamespace
    spans = [Sp(name="song", t0_ns=0, t1_ns=100), Sp(name="step", t0_ns=30, t1_ns=55)]
    busy, idle = profiling.idle_by_span([(10, 20), (15, 30), (50, 60), (95, 120)],
                                        0, 100, spans)
    assert busy == (30 - 10) + (60 - 50) + (100 - 95)
    # gaps (0, 10) and (60, 95) fall in the song; (30, 50) in the step
    assert idle == {"song": pytest.approx(45e-9), "step": pytest.approx(20e-9)}
    busy, idle = profiling.idle_by_span([], 0, 10, [])
    assert busy == 0 and idle == {"outside spans": pytest.approx(10e-9)}


def test_profile_flag_writes_a_trace_and_prints_the_summary(tmp_path, capsys):
    audio = 0.1 * np.random.default_rng(2).standard_normal(16000)
    wav = str(tmp_path / "song.wav")
    write_wav(wav, audio.astype(np.float32), 16000)
    prof_dir = str(tmp_path / "prof")
    cli_transcribe.main([wav, "-m", "t5_tiny", "-t", "mt3_full_plus_256",
                         "--repair-beam", "0", "-o", str(tmp_path / "out"),
                         "--cpu", "--profile", prof_dir])
    assert len(glob.glob(os.path.join(prof_dir, "*.pt.trace.json"))) == 1
    out = capsys.readouterr().out
    for name in ("transcribe", "load_audio", "encode", "decode.step", "write_midi"):
        assert f"span {name}:" in out
    assert "profile: device not traced" in out
    assert "counter decode.greedy_steps: +" in out
    profiling.clear()
