"""Process groups and the device mesh: the port's counterpart of the JAX
package's `yourmt3_tpu/parallel/mesh.py`.

JAX shards a global batch over the `data` axis of one mesh and lets XLA
insert the collectives. The port runs one process per rank instead, as
PyTorch's DistributedDataParallel does: every rank sees the same global
batch, takes its own contiguous slice of the leading axis (what
`P("data")` gives each device) and the gradients are all-reduced. The
group is NCCL's on the card and gloo's on the CPU (or given explicitly:
two ranks on one card need gloo, NCCL refuses them). Ranks meet through
an explicit `init_method`: `env://` under torchrun, a `file://` path in
tests, so that no two runs race for a TCP port.

The `model` axis: `make_mesh` lays the default group out as a 2-D
DeviceMesh ("data", "model"), and `shard_params` places a model's
parameters on its `model` axis Megatron-style, as the JAX package's
`_param_spec`/`shard_params` do (the layers' collectives:
parallel/tensor_parallel.py). The data functions below take such a mesh
where they take a group, and then act on its `data` axis.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .tensor_parallel import ModelAxis

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the JAX package's Megatron layout, on the port's (out, in) weights:
# column-parallel layers split their output features (Shard(0)),
# row-parallel ones their input features (Shard(1))
COLUMN_PARALLEL = ("q", "k", "v", "wi", "wi_0", "wi_1", "lm_head", "pointwise_in")
ROW_PARALLEL = ("o", "wo", "pointwise_out")


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
    """`group` (a mesh's `data` axis for a DeviceMesh), else the default
    group when one is initialised, else None (one process, no
    collectives)."""
    if group is not None:
        return group.get_group(DATA_AXIS) if is_mesh(group) else group
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


# ---------------------------------------------------------------------------
# the model axis: tensor-parallel parameter layout
# ---------------------------------------------------------------------------

def is_mesh(x) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(x, DeviceMesh)


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None):
    """→ a DeviceMesh of shape (n_data, n_model) with dims ("data",
    "model") over the default group (n_data defaults to world / n_model).
    Ranks r·n_model ... r·n_model + n_model - 1 form data row r, as the
    JAX package's reshape of its device list does. The device type is
    that of `device`: CUDA by default, "cpu" when asked."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a mesh of data={n_data} x model={n_model} needs "
                         f"{n_data * n_model} ranks, the group has {world}")
    dev = torch.device(device if device is not None else "cuda")
    return init_device_mesh(dev.type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def param_spec(name: str, param: torch.Tensor, n_model: int = 1):
    """The placement of parameter `name` on the model axis: the port's
    copy of the JAX package's `_param_spec`, on torch's (out, in) layout.
    Column-parallel weights Shard(0), row-parallel ones Shard(1), the
    token embedding (vocab, d) Shard(1) on d_model, the stacked expert
    tensors Shard(0) on the expert axis; everything else, and every tensor
    whose sharded axis `n_model` does not divide, Replicate()."""
    from torch.distributed.tensor import Replicate, Shard
    parts = name.split(".")
    dim = None
    if param.ndim >= 2:
        if parts[-1] == "weight" and len(parts) > 1 and parts[-2] in COLUMN_PARALLEL:
            dim = 0
        elif parts[-1] == "weight" and len(parts) > 1 and parts[-2] in ROW_PARALLEL:
            dim = 1
        elif name == "shared.weight":
            dim = 1
        elif parts[-1] in ("experts_wi", "experts_wo"):
            dim = 0
    if dim is None or param.shape[dim] % n_model:
        return Replicate()
    return Shard(dim)


def shard_params(mesh, model: torch.nn.Module) -> torch.nn.Module:
    """Place `model`'s parameters on the mesh's model axis, in place: rank
    0's weights are first broadcast over the default group, then each
    parameter that `param_spec` shards becomes a DTensor holding this
    rank's slice, and the layers that own one take the axis (their
    collectives). With a model axis of 1 this is plain replication.
    → the model."""
    from torch.distributed.tensor import DTensor, Shard
    from ..models.layers import MoEFeedForward, QuantDense
    replicate(model, dist.group.WORLD if dist.is_initialized() else None)
    sub = mesh[MODEL_AXIS]
    n = sub.size()
    if n == 1:
        return model
    if model.cfg.weight_quant != "none":
        raise ValueError("shard_params trains the fp32 masters: build the model "
                         "with weight_quant='none'")
    axis = ModelAxis(sub.get_group(), sub.get_local_rank(), n)
    for mod_name, mod in model.named_modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            spec = param_spec(f"{mod_name}.{pname}" if mod_name else pname, p, n)
            if not isinstance(spec, Shard):
                continue
            shard = p.detach().chunk(n, dim=spec.dim)[axis.rank].contiguous()
            setattr(mod, pname, torch.nn.Parameter(DTensor.from_local(
                shard, sub, [spec], run_check=False, shape=p.shape,
                stride=p.stride())))
            if isinstance(mod, QuantDense):
                mod.tp, mod.tp_style = axis, ("column", "row")[spec.dim]
            elif isinstance(mod, MoEFeedForward):
                mod.tp = axis
            else:  # the token embedding, split on d_model
                model.embed_tp = axis
    return model
