"""The data-parallel process group: the port's counterpart of the JAX
package's device mesh (`yourmt3_tpu/parallel/mesh.py`).

JAX shards a global batch over the `data` axis of one mesh and lets XLA
insert the collectives. The port runs one process per rank instead, as
PyTorch's DistributedDataParallel does: every rank sees the same global
batch, takes its own contiguous slice of the leading axis (what
`P("data")` gives each device) and the gradients are all-reduced. The
group is NCCL's on the card and gloo's on the CPU (or given explicitly:
two ranks on one card need gloo, NCCL refuses them). Ranks meet through
an explicit `init_method`: `env://` under torchrun, a `file://` path in
tests, so that no two runs race for a TCP port.

The tensor-parallel layout of the `model` axis is not ported.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist


def init_data_parallel(rank: Optional[int] = None, world_size: Optional[int] = None,
                       init_method: Optional[str] = None,
                       backend: Optional[str] = None, device=None,
                       timeout_s: float = 600.0):
    """Initialise the default process group, or return it when it exists.

    rank and world_size default to torchrun's RANK and WORLD_SIZE;
    init_method to `env://` (MASTER_ADDR/MASTER_PORT). backend defaults to
    "nccl" for a CUDA `device` (the default) and "gloo" for the CPU. On
    the card each rank takes LOCAL_RANK's device. → the group."""
    if dist.is_initialized():
        return dist.group.WORLD
    dev = torch.device(device if device is not None else "cuda")
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if dev.type == "cuda" and backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dev.index or 0)))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dist.group.WORLD


def destroy() -> None:
    """Leave the default process group (after init_data_parallel)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, init_method: str, backend: str = "gloo",
                device="cpu", timeout_s: float = 600.0, args: tuple = ()) -> None:
    """Run fn(rank, world, *args) in `world` spawned processes of this
    host, each a rank of one default group (`init_data_parallel` with
    these arguments, left when fn returns). CPU ranks take one intra-op
    thread each; CUDA ranks take `device`, or cuda:<rank> when it has no
    index. Raises what a rank raised, or TimeoutError once `timeout_s`
    has passed; no rank outlives the call."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_spawned_rank, nprocs=world, join=False,
                             start_method="spawn",
                             args=(fn, world, init_method, backend, str(device),
                                   timeout_s, args))
    deadline = time.monotonic() + timeout_s
    try:
        # join returns when a rank ends; True once all have ended
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{getattr(fn, '__name__', fn)}: ranks still "
                                   f"running after {timeout_s:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def _spawned_rank(rank, fn, world, init_method, backend, device, timeout_s, args):
    dev = torch.device(device)
    if dev.type == "cuda":
        local = rank if dev.index is None else dev.index
        os.environ["LOCAL_RANK"] = str(local)  # init_data_parallel's NCCL device
        torch.cuda.set_device(local)
    else:
        torch.set_num_threads(1)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # the ranks share one host
    init_data_parallel(rank, world, init_method=init_method, backend=backend,
                       device=dev, timeout_s=timeout_s)
    try:
        fn(rank, world, *args)
    finally:
        destroy()


def data_group(group=None):
    """`group`, else the default group when one is initialised, else None
    (one process, no collectives)."""
    if group is not None:
        return group
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def world_size(group=None) -> int:
    group = data_group(group)
    return 1 if group is None else dist.get_world_size(group)


def rank(group=None) -> int:
    group = data_group(group)
    return 0 if group is None else dist.get_rank(group)


def shard_batch(batch: Dict[str, np.ndarray], group=None) -> Dict[str, np.ndarray]:
    """This rank's contiguous slice of the leading axis of every array of
    a global batch; the leading axis must divide by the world size."""
    n, r = world_size(group), rank(group)
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.shape[0] % n:
            raise ValueError(f"batch[{k!r}] has {v.shape[0]} rows, which do not "
                             f"split over {n} ranks")
        per = v.shape[0] // n
        out[k] = v[r * per:(r + 1) * per]
    return out


def _src(group) -> int:
    return 0 if group is dist.group.WORLD else dist.get_global_rank(group, 0)


def replicate(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place.
    → the module."""
    group = data_group(group)
    if group is not None:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, src=_src(group), group=group)
    return module


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Concatenate every rank's (n, ...) tensor along the leading axis, in
    rank order (all ranks hold the same shape)."""
    group = data_group(group)
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)
