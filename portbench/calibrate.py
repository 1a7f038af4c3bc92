"""Readings for the limits of a cell's correctness check, on the card.

    python3 portbench/calibrate.py --workload mc13.train --seeds 1,2,3 \
        --control-seeds 4,5,6 --out chiprun_out/calibrate_mc13.train.jsonl

For every seed, one process runs the cell's set-up and its check with no
measured window (one song, or the checked training steps) and writes the
compared numbers: the program's readings, which set the lower end of each
limit. On the control seeds it also reads the control, the reference put
in the program's place one precision below the configuration's (serving:
int4 decoder weights and K/V; training: float8 products), and, for
training, the fault of a loss over half of each batch. One JSON line per
seed, to --out and to standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from harness import core  # noqa: E402

CONTROLS = {"transcribe": dict(weight_bits=4, self_kv_bits=4, cross_kv_bits=4),
            "train": dict(fp8_products=True)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    core.cache_env()
    sys.path.insert(1, core.REPO)
    import torch
    from reference import model as ref
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = core.find_cell(args.workload)
    drv = core.driver(cell)
    control = ref.Numerics(**CONTROLS[cell.traffic["kind"]])
    seeds = [(int(s), None) for s in args.seeds.split(",") if s]
    seeds += [(int(s), control) for s in args.control_seeds.split(",") if s]
    out = open(args.out, "a") if args.out else None
    for seed, ctl in seeds:
        t0 = time.perf_counter()
        run = drv.run(cell, seed, 0.0, False, torch.device("cuda", 0), t0, control=ctl)
        line = json.dumps({"workload": cell.name, "seed": seed, "control": ctl is not None,
                           "checks": {k: c["value"] for k, c in run.checks.items()},
                           "notes": run.notes,
                           "seconds": time.perf_counter() - t0,
                           "card": torch.cuda.get_device_name(0)})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
