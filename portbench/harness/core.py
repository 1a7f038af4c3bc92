"""What a run is: its cell, found by name in BENCHMARK.json and in the
files beside it, the record it fills, and the result line it prints.

Everything of one configuration, traffic mix, metric or cell lives in a
file of its own: `configs/<config>.json` (named by BENCHMARK.json),
`traffic/<traffic>.json` (its "kind" names the driver
`drivers/<kind>.py`), `metrics/<metric>.py` (a reader) and
`limits/<workload>.json` (the limits of the correctness check).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH_DIR)
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "yourmt3_tpu")


def read_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import a file by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict

    @property
    def name(self) -> str:
        return self.workload["name"]


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or read_json(os.path.join(REPO, "BENCHMARK.json"))
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        workload=w,
        config=read_json(os.path.join(REPO, conf["file"])),
        traffic=read_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        limits=read_json(os.path.join(BENCH_DIR, "limits", name + ".json")))


def driver(cell: Cell):
    kind = cell.traffic["kind"]
    return load_module(os.path.join(BENCH_DIR, "drivers", kind + ".py"),
                       f"portbench_driver_{kind}")


def reader(metric: str) -> Callable:
    return load_module(os.path.join(BENCH_DIR, "metrics", metric + ".py"),
                       "portbench_metric_" + metric.replace(".", "_")).read


@dataclasses.dataclass
class Span:
    name: str
    t0_ns: int  # time.time_ns(), the profiler's clock
    t1_ns: int


@dataclasses.dataclass
class Run:
    """What a driver measured: the window, counts, host spans, the trace
    summary (traced runs) and the outcome of the correctness check."""

    cell: Cell
    seed: int
    setup_s: float = 0.0
    window_s: float = 0.0
    peak_bytes: int = 0
    counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    calls: List[dict] = dataclasses.field(default_factory=list)
    spans: List[Span] = dataclasses.field(default_factory=list)
    trace: Optional[Any] = None  # harness.trace.Summary
    checks: Dict[str, dict] = dataclasses.field(default_factory=dict)
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)  # diagnostics

    def span(self, name: str):
        return _SpanCtx(self, name)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            c["value"] is not None and c["value"] <= c["limit"]
            for c in self.checks.values())


class _SpanCtx:
    def __init__(self, run: Run, name: str):
        self.run, self.name = run, name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.run.spans.append(Span(self.name, self.t0, time.time_ns()))
        return False


def host_probe_ms() -> float:
    """Milliseconds the host takes for a fixed piece of pure-Python work: a
    gauge of the host's speed, kept in the notes beside a run's times."""
    t0 = time.perf_counter()
    x = 0
    for i in range(100_000):
        x += i * i
    return 1e3 * (time.perf_counter() - t0)


def sync(device) -> None:
    """Wait for the device's work (a no-op on the CPU)."""
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def banned_modules() -> List[str]:
    """Top-level names of loaded modules that must not be loaded."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def run_dir() -> str:
    """A fresh directory for the run's files: under TMPDIR when it is set,
    else under the checkout's git-ignored `.portbench_tmp`."""
    import tempfile
    base = os.environ.get("TMPDIR") or os.path.join(REPO, ".portbench_tmp")
    os.makedirs(base, exist_ok=True)
    return tempfile.mkdtemp(prefix="portbench_", dir=base)


def remove_dir(path: str) -> None:
    import shutil
    shutil.rmtree(path, ignore_errors=True)


def cache_env() -> None:
    """Fixed build and kernel-cache directories inside the checkout, set
    before torch is imported; few host threads."""
    cache = os.path.join(REPO, ".portbench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "2"
