"""The control, the reference put in the program's place one precision
below the configuration's (calibrate.CONTROLS), comes out not correct
under each cell's limits: at tiny widths on the CPU, and at the cell's
own size on a card (marked `cuda`; skips without one)."""

import time

import pytest
import torch

import calibrate
from harness import core
from reference import model as ref
from pb_tiny import tiny_cell

WORKLOADS = ["mc13.transcribe", "mc13.train", "moe.train", "t5_small.transcribe"]


def control_fails(cell, device, seed) -> bool:
    control = ref.Numerics(**calibrate.CONTROLS[cell.traffic["kind"]])
    run = core.driver(cell).run(cell, seed, 0.0, False, device, time.perf_counter(),
                                control=control)
    readings = {k[len("control_"):]: c for k, c in run.checks.items()
                if k.startswith("control_")}
    assert readings
    return any(c["value"] > c["limit"] for c in readings.values())


@pytest.mark.parametrize("name", WORKLOADS)
def test_control_fails_at_tiny_widths(name):
    torch.set_num_threads(2)
    assert control_fails(tiny_cell(name), torch.device("cpu"), 31)


@pytest.mark.cuda
@pytest.mark.parametrize("name", WORKLOADS)
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's own size")
    core.cache_env()
    assert control_fails(core.find_cell(name), torch.device("cuda", 0), 32)
