"""The device trace of a traced run, reduced to what the readers need.

torch.profiler records the CUDA activity (kernels, copies, memsets) of
the window; the events are read from the profiler's results in memory,
without writing a trace file. Busy time is the union of the device
intervals, so kernels that overlap count once; sums by name are kept for
the breakdown and the rooflines. Idle gaps are put down to the host span
(harness.core.Span, on time.time_ns) that was open in their middle; a
short spin kernel launched right after the window opens anchors the
device's clock to the host's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    by_name: Dict[str, Tuple[int, float]]  # name → (count, seconds)
    gaps_by_span: Dict[str, float]  # host span → idle seconds

    def kernel_seconds(self, names) -> Tuple[int, float]:
        """(launches, device seconds) of kernels whose name contains one of
        `names`."""
        n, s = 0, 0.0
        for name, (cnt, sec) in self.by_name.items():
            if any(k in name for k in names):
                n, s = n + cnt, s + sec
        return n, s

    def breakdown(self) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = sorted(self.gaps_by_span.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:200], s] for n, (_, s) in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start ns, end ns) of every device activity."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


class DeviceTrace:
    """Context manager around a traced window: `with DeviceTrace() as t:`,
    then `t.summary(spans)`."""

    def __init__(self):
        self.prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.time_ns()
        torch.cuda._sleep(1000)  # the clock anchor: a "spin_kernel"
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        self.t1 = time.time_ns()
        self.prof.__exit__(*exc)
        return False

    def summary(self, spans) -> Summary:
        events = _device_events(self.prof)
        spin = [s for name, s, _ in events if "spin_kernel" in name]
        # device clock minus host clock; the anchor starts a launch after t0
        offset = spin[0] - self.t0 if spin else 0
        events = [(n, s - offset, e - offset) for n, s, e in events
                  if "spin_kernel" not in n]
        return summarize(events, self.t0, self.t1, spans)


def summarize(events, t0: int, t1: int, spans) -> Summary:
    """Reduce (name, start, end) device events inside [t0, t1] (ns)."""
    by_name: Dict[str, Tuple[int, float]] = {}
    ivals = []
    for name, s, e in events:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        cnt, sec = by_name.get(name, (0, 0.0))
        by_name[name] = (cnt + 1, sec + (e - s) * 1e-9)
        ivals.append((s, e))
    ivals.sort()
    busy, gaps = 0, []
    cur_s: Optional[int] = None
    cur_e = t0
    for s, e in ivals:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    gaps.append((cur_e, t1))
    gaps_by_span: Dict[str, float] = {}
    inner = sorted(spans, key=lambda sp: sp.t1_ns - sp.t0_ns)  # innermost first
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        label = next((sp.name for sp in inner if sp.t0_ns <= mid < sp.t1_ns),
                     "outside spans")
        gaps_by_span[label] = gaps_by_span.get(label, 0.0) + (g1 - g0) * 1e-9
    return Summary(window_s=(t1 - t0) * 1e-9, busy_s=busy * 1e-9,
                   by_name=by_name, gaps_by_span=gaps_by_span)
