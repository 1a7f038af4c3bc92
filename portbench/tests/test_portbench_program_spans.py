"""The readers of the program's own spans (harness/program_spans.py): on
synthetic spans, on a program without them (None, no error), and in a
traced run on the CPU, where a profiler over CPU activity stands in for
the card's trace and turns the program's recording on."""

import time
import types

import pytest
import torch

from harness import core
from harness.trace import Summary
from pb_tiny import tiny_cell

torch.set_num_threads(2)
DECODE = ("decode_enqueue_ms_per_step", "decode_loop_self_ms_per_step")
TRAIN = ("train_host_ms_per_step", "forward_device_ms_per_step",
         "backward_device_ms_per_step", "optimizer_device_ms_per_step")


def sp(id, name, t0, t1, parent=None, device_ms=None):
    return types.SimpleNamespace(id=id, name=name, t0_ns=t0, t1_ns=t1,
                                 parent=parent, device_ms=device_ms)


MS = 1_000_000
SYNTHETIC = [
    sp(1, "transcribe", 0, 100 * MS),
    sp(2, "decode.greedy", 0, 40 * MS, 1),
    sp(3, "decode.done_read", 0, 1 * MS, 2),
    sp(4, "decode.step", 1 * MS, 11 * MS, 2),
    sp(5, "decode.done_read", 12 * MS, 14 * MS, 2),
    sp(6, "decode.step", 14 * MS, 30 * MS, 2),
    sp(7, "decode.beam", 50 * MS, 70 * MS, 1),
    sp(8, "decode.step", 51 * MS, 63 * MS, 7),
    sp(9, "kernel.inside", 52 * MS, 53 * MS, 8),  # a grandchild: not subtracted
    sp(10, "train.step", 0, 8 * MS),
    sp(11, "train.forward", 0, 2 * MS, 10, device_ms=3.0),
    sp(12, "train.backward", 2 * MS, 4 * MS, 10, device_ms=5.0),
    sp(13, "train.optimizer", 4 * MS, 6 * MS, 10, device_ms=2.0),
    sp(14, "train.step", 10 * MS, 14 * MS),
    sp(15, "train.forward", 10 * MS, 11 * MS, 14, device_ms=1.0),
    sp(16, "train.backward", 11 * MS, 12 * MS, 14, device_ms=None),
]


def read(metric):
    return core.reader(metric)(None)


def test_readers_on_synthetic_spans(monkeypatch):
    from yourmt3_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "spans", lambda: list(SYNTHETIC))
    assert read("decode_enqueue_ms_per_step") == pytest.approx((10 + 16 + 12) / 3)
    # loops 40 + 20 ms, less their children 1 + 10 + 2 + 16 and 12, over 3 steps
    assert read("decode_loop_self_ms_per_step") == pytest.approx(
        (60 - 29 - 12) / 3)
    assert read("train_host_ms_per_step") == pytest.approx(6.0)
    assert read("forward_device_ms_per_step") == pytest.approx(2.0)
    assert read("backward_device_ms_per_step") == pytest.approx(5.0)
    assert read("optimizer_device_ms_per_step") == pytest.approx(2.0)


def test_readers_return_none_without_spans(monkeypatch):
    from yourmt3_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert all(read(m) is None for m in DECODE + TRAIN)
    monkeypatch.delattr(profiling, "spans")  # a program that keeps none
    assert all(read(m) is None for m in DECODE + TRAIN)


class CpuProfiledTrace:
    """The harness's DeviceTrace on the CPU: a profiler over CPU activity,
    which turns the program's recording on as the card's trace does."""

    def __enter__(self):
        from yourmt3_tpu_torch.utils import profiling
        profiling.clear()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def summary(self, spans):
        return Summary(window_s=1.0, busy_s=0.5, by_name={}, gaps_by_span={})


@pytest.mark.parametrize("name", ["mc13.transcribe", "mc13.train"])
def test_traced_run_reads_the_programs_spans(name, monkeypatch):
    from yourmt3_tpu_torch.utils import profiling
    cell = tiny_cell(name, trace_seconds=0)
    drv = core.driver(cell)
    monkeypatch.setattr(drv, "DeviceTrace", CpuProfiledTrace)
    run = drv.run(cell, 41, 0.0, True, torch.device("cpu"), time.perf_counter())
    assert run.correct
    got = profiling.spans()
    if cell.traffic["kind"] == "transcribe":
        traced = [c for c in run.calls if c["traced"]]
        assert sum(s.name == "decode.step" for s in got) == sum(
            c["steps"] for c in traced) > 0
        assert read("decode_enqueue_ms_per_step") > 0
        assert read("decode_loop_self_ms_per_step") > 0
    else:
        assert sum(s.name == "train.step" for s in got) >= 1
        assert read("train_host_ms_per_step") > 0
        # no card: the phases have no device time
        assert all(read(m) is None for m in TRAIN[1:])
    profiling.clear()
