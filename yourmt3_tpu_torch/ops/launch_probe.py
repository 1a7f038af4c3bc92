"""Launch-overhead probe: out = x + 1 on an (8, 128) fp32 tile.

The kernel (`csrc/launch_probe.cu`) does next to no work, so its time per
launch, issued eagerly or replayed in a CUDA graph, is the cost of a
launch. `launch_probe` launches it for CUDA tensors and runs
`launch_probe_plain` for CPU tensors; it never falls back from one to the
other.
"""

from __future__ import annotations

import ctypes

import torch

from .decode_attention import _check

_KERNEL = "launch_probe"
SHAPE = (8, 128)


def launch_probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def _library() -> ctypes.CDLL:
    from .cuda_build import load
    lib = load(_KERNEL)
    fn = lib.launch_probe_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def launch_probe(x: torch.Tensor) -> torch.Tensor:
    """(8, 128) fp32 → x + 1. CPU tensors go to the plain version; CUDA
    tensors launch the kernel (and count one launch) or raise."""
    if x.device.type == "cpu":
        return launch_probe_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"launch_probe runs on cuda or cpu, not {x.device}")
    _check(x, "x", x.device, torch.float32, SHAPE)
    out = torch.empty_like(x)
    err = _library().launch_probe_launch(
        x.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch_probe launch failed: CUDA error {err}")
    launch_probe.launches += 1
    return out


launch_probe.launches = 0  # kernel launches since the last reset
