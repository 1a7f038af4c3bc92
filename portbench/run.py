"""The port's benchmark: one run of one cell, one JSON line.

    python3 portbench/run.py --workload mc13.transcribe --seed 7 --seconds 51 --trace 0

Runs from the root of a checkout that holds BENCHMARK.json, portbench/
and the port (yourmt3_tpu_torch/), on a machine with the CUDA cards the
cell asks for, and exits non-zero without a result otherwise. With
--trace 0 the metrics are the cell's end-to-end metrics, with --trace 1
its per-layer metrics and the device's busy and window seconds. The
correctness check runs after the window in both. Each number the check
compares is printed beside its limit, last on standard error and last in
the result line ("checks").
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from harness import core  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr)
    return 2


def metrics_of(run: core.Run, specs) -> dict:
    out = {}
    for m in specs:
        value = core.reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    if not os.path.isdir(os.path.join(core.REPO, "yourmt3_tpu_torch")):
        return fail(f"no yourmt3_tpu_torch/ beside portbench/ in {core.REPO}")
    core.cache_env()
    sys.path.insert(1, core.REPO)
    cell = core.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the port on the GPU")
    if torch.cuda.device_count() < cell.workload["chips"]:
        return fail(f"{cell.name} needs {cell.workload['chips']} cards, "
                    f"found {torch.cuda.device_count()}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    run = core.driver(cell).run(cell, args.seed, args.seconds, bool(args.trace),
                                device, T_START)
    banned = core.banned_modules()
    if banned:
        return fail(f"modules that must not load were loaded: {banned}")
    result = {
        "correct": run.correct,
        "attempted": run.counts.get("songs", run.counts.get("steps", 0)),
        "failed": 0,
        "metrics": metrics_of(run, cell.per_layer if args.trace else cell.end_to_end),
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": cell.workload["chips"],
                   "memory_peak_bytes": run.peak_bytes},
    }
    if args.trace:
        result["device"].update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = run.checks
    if run.notes:
        print("notes " + json.dumps(run.notes), file=sys.stderr)
    for name, c in run.checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
