"""Tracing and profiling hooks (the JAX package's `utils/profiling.py`):
`trace` records a torch.profiler trace (the CUDA kernels included when a
card is present) that Chrome's trace viewer and TensorBoard's profiler
plugin read, `annotate` names a span in it, and `StepTimer` keeps a
wall-time EMA per named phase that train.trainer.MetricLogger can log.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str = "ymt3_trace") -> Iterator[torch.profiler.profile]:
    """`with trace("runs/trace"):` → a `<host>.<pid>.<time>.pt.trace.json`
    under log_dir; yields the profiler (its key_averages() too)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


annotate = torch.profiler.record_function  # `with annotate("decode"):`


class StepTimer:
    """Wall-time EMA per named phase; cheap enough to leave on."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema = {}

    @contextlib.contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.ema[name] = (dt if name not in self.ema
                          else self.alpha * dt + (1 - self.alpha) * self.ema[name])

    def summary(self) -> dict:
        return {f"time/{k}": v for k, v in self.ema.items()}
