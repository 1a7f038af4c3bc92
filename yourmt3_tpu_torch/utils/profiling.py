"""The port's spans, counters and traces.

`span(name, device=None)` names a part of the work. It records only while
recording is on: while any torch profiler session runs (torch's own flag
for cheap checks, `torch.autograd.profiler._is_profiler_enabled`, which
every profiler sets, whatever its activities), or between `enable()` and
`disable()`. Off, it returns one shared no-op context after a check of
those two flags: no clock is read, nothing is allocated, no CUDA event is
made. On, it keeps a `Span`: its name, its bounds on `time.time_ns()`, the
id of the span open around it on the same thread (`parent`) and of the
outermost one (`request`: one transcription, one train step) and, with a
CUDA `device`, the stream time between two CUDA events recorded at its
bounds (`device_ms`: its kernels and any idle time between them, resolved
when `spans()` is read). Under a profiler it also opens
`torch.profiler.record_function(name)`, so the Chrome trace shows it on
the kernels' timeline.

The latest 2**16 spans are kept in memory (`spans()`, `clear()`;
`dropped()` counts those the bound pushed out). `counters()` is a snapshot
of the counts the port keeps, each registered once by the module that
keeps it (`register`). `trace(log_dir)` runs the profiler with its
TensorBoard/Chrome handler and, on exit, prints and keeps the operator's
summary: the device's busy and idle share, idle seconds by the innermost
span open at each gap's middle, the spans by name and each counter's
change.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 2 ** 16
ANCHOR = "profiling.clock_anchor"  # the trace's host-clock anchor

_enabled = False
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_dropped = 0
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_counters: Dict[str, Callable[[], int]] = {}


class Span:
    """One recorded span; the field names are those of the benchmark's
    host spans (`t0_ns`, `t1_ns` on `time.time_ns()`)."""

    __slots__ = ("name", "id", "parent", "request", "t0_ns", "t1_ns",
                 "device_ms", "_events")

    def __init__(self, name: str, parent: Optional["Span"]):
        self.name = name
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.request = parent.request if parent is not None else self.id
        self.t0_ns = self.t1_ns = 0
        self.device_ms: Optional[float] = None
        self._events = None

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, ms={(self.t1_ns - self.t0_ns) * 1e-6:.3f}, "
                f"device_ms={self.device_ms})")


class _NoSpan:
    """The shared context of `span` while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


def _stack() -> List[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Recording:
    __slots__ = ("name", "device", "span", "rf")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self) -> Span:
        stack = _stack()
        sp = self.span = Span(self.name, stack[-1] if stack else None)
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if self.device and torch.device(self.device).type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            sp._events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True), stream)
            sp._events[0].record(stream)
        stack.append(sp)
        sp.t0_ns = time.time_ns()
        return sp

    def __exit__(self, *exc):
        global _dropped
        sp = self.span
        sp.t1_ns = time.time_ns()
        _stack().pop()
        if sp._events is not None:
            sp._events[1].record(sp._events[2])
        if self.rf is not None:
            self.rf.__exit__(*exc)
        with _lock:
            if len(_spans) == _spans.maxlen:
                _dropped += 1
            _spans.append(sp)
        return False


def recording() -> bool:
    return _enabled or _autograd_profiler._is_profiler_enabled


def span(name: str, device=None):
    """`with span("decode.step"):` records a span while recording is on.
    device: the torch.device whose current stream the span also times
    (`device_ms`, CUDA only); None (or False) times nothing on a device."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return _NOOP
    return _Recording(name, device)


def request(name: str):
    """`span(name)` as the root of a request, or nothing when a span is
    already open on this thread (the caller is then part of a request)."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled) or _stack():
        return _NOOP
    return _Recording(name, None)


def enable() -> None:
    """Record spans without a profiler (until `disable()`)."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def spans() -> List[Span]:
    """The recorded spans, oldest first (each appended when it closes, so
    a child comes before its parent); device times are resolved here."""
    with _lock:
        out = list(_spans)
    for sp in out:
        if sp._events is not None:
            start, end, _ = sp._events
            end.synchronize()
            sp.device_ms = start.elapsed_time(end)
            sp._events = None
    return out


def clear() -> None:
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


def dropped() -> int:
    """Spans lost to the bound since the last `clear()`."""
    return _dropped


def register(name: str, count: Callable[[], int]) -> None:
    """Make `count()` part of `counters()` under `name` (once per module)."""
    _counters[name] = count


def counters() -> Dict[str, int]:
    """A snapshot of every registered count, by name."""
    return {name: int(count()) for name, count in sorted(_counters.items())}


# ---------------------------------------------------------------------------
# the operator's trace
# ---------------------------------------------------------------------------

def idle_by_span(intervals, t0: int, t1: int, spans_) -> tuple:
    """Device (start, end) intervals (ns) inside [t0, t1] → (busy ns,
    {span name: idle s}): busy is their union, so overlaps count once;
    each idle gap goes to the innermost span open at its middle ("outside
    spans" if none), as the benchmark's trace reduction does."""
    ivals = sorted((max(s, t0), min(e, t1)) for s, e in intervals)
    busy, gaps, cur_s, cur_e = 0, [], None, t0
    for s, e in ivals:
        if e <= s:
            continue
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
    inner = sorted(spans_, key=lambda sp: sp.t1_ns - sp.t0_ns)
    idle: Dict[str, float] = {}
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        name = next((sp.name for sp in inner if sp.t0_ns <= mid < sp.t1_ns),
                    "outside spans")
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-9
    return busy, idle


def _summary(prof, t0: int, t1: int, anchor_ns: int, before: Dict[str, int],
             cuda: bool) -> dict:
    from torch.autograd import DeviceType
    window = [sp for sp in spans() if t0 <= sp.t0_ns and sp.t1_ns <= t1]
    by_name: Dict[str, list] = {}
    for sp in window:
        row = by_name.setdefault(sp.name, [0, 0.0, None])
        row[0] += 1
        row[1] += (sp.t1_ns - sp.t0_ns) * 1e-9
        if sp.device_ms is not None:
            row[2] = (row[2] or 0.0) + sp.device_ms * 1e-3
    after = counters()
    out = {"window_s": (t1 - t0) * 1e-9, "busy_s": None, "idle_share": None,
           "idle_by_span": {},
           "spans": {n: {"count": c, "host_s": h, "device_s": d}
                     for n, (c, h, d) in sorted(by_name.items())},
           "counters": {n: v - before.get(n, 0) for n, v in after.items()
                        if v != before.get(n, 0)},
           "dropped": dropped()}
    if cuda:
        events = prof.profiler.kineto_results.events()
        anchor = [e.start_ns() for e in events if e.name() == ANCHOR]
        # the profiler's clock minus time.time_ns(), from the anchor range
        offset = anchor[0] - anchor_ns if anchor else 0
        # kernels, copies and memsets; not the spans' ranges that kineto
        # repeats on the device's timeline (gpu_user_annotation)
        device = [(e.start_ns() - offset, e.start_ns() + e.duration_ns() - offset)
                  for e in events
                  if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0
                  and not e.is_user_annotation()]
        busy, idle = idle_by_span(device, t0, t1, window)
        out.update(busy_s=busy * 1e-9, idle_share=1.0 - busy / max(t1 - t0, 1),
                   idle_by_span=dict(sorted(idle.items(), key=lambda kv: -kv[1])))
    return out


def _format(s: dict) -> str:
    lines = [f"profile: window {s['window_s']:.3f} s"]
    if s["busy_s"] is None:
        lines.append("profile: device not traced (no CUDA device)")
    else:
        lines.append(f"profile: device busy {s['busy_s']:.3f} s, idle "
                     f"{100 * s['idle_share']:.1f} % of the window")
        lines += [f"profile:   idle in {n}: {v:.3f} s"
                  for n, v in list(s["idle_by_span"].items())[:10]]
    for n, r in s["spans"].items():
        dev = "" if r["device_s"] is None else f", device {r['device_s']:.3f} s"
        lines.append(f"profile: span {n}: {r['count']} × "
                     f"{1e3 * r['host_s'] / r['count']:.3f} ms host{dev}")
    lines += [f"profile: counter {n}: +{v}" for n, v in s["counters"].items()]
    if s["dropped"]:
        lines.append(f"profile: {s['dropped']} spans dropped (bound {MAX_SPANS})")
    return "\n".join(lines)


class Trace:
    """What `trace` yields: the profiler (`prof`) and, after the block,
    the summary it printed (`summary`, a dict)."""

    def __init__(self, prof):
        self.prof = prof
        self.summary: Optional[dict] = None


@contextlib.contextmanager
def trace(log_dir: str = "ymt3_trace") -> Iterator[Trace]:
    """`with trace("runs/trace") as t:` → a `<host>.<pid>.<time>.pt.trace.json`
    under log_dir (CPU ranges, the program's spans and, with a card, its
    kernels), then the summary printed and kept in `t.summary`."""
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    before = counters()
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        t = Trace(prof)
        anchor_ns = time.time_ns()
        with torch.profiler.record_function(ANCHOR):
            pass
        t0 = time.time_ns()
        yield t
        if cuda:
            torch.cuda.synchronize()
        t1 = time.time_ns()
    t.summary = _summary(prof, t0, t1, anchor_ns, before, cuda)
    print(_format(t.summary))
