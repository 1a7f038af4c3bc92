"""A traced run measures the untraced window first, for the host-clock
metrics, and traces what comes after it, for the device metrics. The
profiler is stood in for on the CPU."""

import time

import pytest
import torch

from harness import core
from harness.trace import Summary
from pb_tiny import tiny_cell

torch.set_num_threads(2)


class FakeTrace:
    entered = 0

    def __enter__(self):
        FakeTrace.entered += 1
        return self

    def __exit__(self, *exc):
        return False

    def summary(self, spans):
        return Summary(window_s=2.0, busy_s=0.5,
                       by_name={"int4_cross_kernel": (8, 1e-3),
                                "paged_decode_kernel": (8, 1e-3)}, gaps_by_span={})


def traced_run(name: str, monkeypatch) -> core.Run:
    cell = tiny_cell(name, trace_seconds=0)
    drv = core.driver(cell)
    monkeypatch.setattr(drv, "DeviceTrace", FakeTrace)
    FakeTrace.entered = 0
    run = drv.run(cell, 31, 0.0, True, torch.device("cpu"), time.perf_counter())
    assert FakeTrace.entered == 1 and run.trace.busy_s == 0.5
    return run


def test_transcribe_host_metrics_leave_the_traced_song_out(monkeypatch):
    run = traced_run("mc13.transcribe", monkeypatch)
    assert run.correct and run.counts["songs"] == 2
    traced = [c for c in run.calls if c["traced"]]
    window = [c for c in run.calls if not c["traced"]]
    assert traced and window
    host = core.reader("decode_host_ms_per_step")(run)
    assert host == pytest.approx(1e3 * sum(c["host_s"] for c in window)
                                 / sum(c["steps"] for c in window))
    assert core.reader("int4_xattn_roofline")(run) > 0
    assert core.reader("device_idle.transcribe")(run) == pytest.approx(75.0)


def test_prefixed_transcribe_reads_every_metric_of_its_cell(monkeypatch):
    run = traced_run("t5_small.transcribe", monkeypatch)
    assert run.correct and run.counts["songs"] == 2
    for m in run.cell.per_layer:
        if m["source"] != "program_span":  # the program records spans under a profiler
            assert core.reader(m["name"])(run) > 0, m["name"]
    assert "int4_xattn_roofline" not in {m["name"] for m in run.cell.per_layer}


def test_train_window_closes_before_the_traced_steps(monkeypatch):
    run = traced_run("mc13.train", monkeypatch)
    assert run.correct and run.counts["steps"] == 1 and run.window_s > 0
    assert core.reader("mfu.train")(run) > 0
