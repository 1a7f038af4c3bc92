"""Launch-overhead probe: out = x + 1 on an (8, 128) fp32 tile.

The kernel (`csrc/launch_probe.cu`) does next to no work, so its time per
launch, issued eagerly or replayed in a CUDA graph, is the cost of a
launch through the port's binding (the PyTorch operator
`torch.ops.yourmt3_tpu_torch.launch_probe`). `launch_probe` launches it
for CUDA tensors and runs `launch_probe_plain` for CPU tensors; it never
falls back from one to the other.
"""

from __future__ import annotations

import torch

from ..utils import profiling
from . import cuda_build

SHAPE = (8, 128)


def launch_probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


_op = None  # torch.ops.yourmt3_tpu_torch.launch_probe, bound at first use


def launch_probe(x: torch.Tensor) -> torch.Tensor:
    """(8, 128) fp32 → x + 1. CPU tensors go to the plain version; CUDA
    tensors launch the kernel through its operator, which checks the
    argument (and count one launch), or raise."""
    if x.is_cpu:
        return launch_probe_plain(x)
    global _op
    if _op is None:
        _op = cuda_build.op("launch_probe")
    out = _op(x)
    launch_probe.launches += 1
    return out


launch_probe.launches = 0  # kernel launches since the last reset
profiling.register("kernel.launch_probe.launches",
                   lambda f=launch_probe: f.launches)
