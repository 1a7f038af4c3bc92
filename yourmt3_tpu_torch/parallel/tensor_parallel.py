"""Tensor parallelism over the `model` axis: the collectives of the
Megatron recipe, as autograd functions, and the handle a sharded module
keeps.

The JAX package shards its parameters over the mesh's `model` axis and
lets GSPMD insert the reductions (parallel/mesh.py there). The port keeps
the activations local instead, as torch's own tensor-parallel styles do:
a column-parallel layer (weight `Shard(0)`, output features split)
computes the rank's slice of the output features from the whole input; a
row-parallel layer (`Shard(1)`, input features split) computes a partial
sum from the rank's slice of the input features, which an all-reduce
completes. Every rank of the model axis holds the same replicated
activations between those layers, so the loss, and the gradient of every
replicated parameter, is the same on each.

The four functions below are each other's adjoints under that rule
(forward / backward):
    copy_to        identity      / all-reduce
    reduce_from    all-reduce    / identity
    gather_from    all-gather    / this rank's slice
    scatter_to     this rank's slice / all-gather
Collectives carry fp32 (a bf16 tensor is widened and narrowed back, which
is exact for the gathers) and use only all-reduce and all-gather, which
gloo carries on CUDA tensors as well as on the CPU. `traffic` counts the
calls and the bytes each rank sends into them since the last reset.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True, eq=False)
class ModelAxis:
    """This rank's place on the model axis: its process group, its index
    in it and the axis size."""

    group: Any
    rank: int
    size: int


def _wide(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32) if x.dtype in (torch.bfloat16, torch.float16) else x


traffic = {"all_reduce": 0, "all_gather": 0, "bytes": 0}


def _count(kind: str, t: torch.Tensor) -> None:
    traffic[kind] += 1
    traffic["bytes"] += t.numel() * t.element_size()


def _all_reduce(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    y = _wide(x).contiguous().clone()
    _count("all_reduce", y)
    dist.all_reduce(y, group=axis.group)
    return y.to(x.dtype)


def _all_gather(x: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    x32 = _wide(x).contiguous()
    _count("all_gather", x32)
    parts = [torch.empty_like(x32) for _ in range(axis.size)]
    dist.all_gather(parts, x32, group=axis.group)
    return torch.cat(parts, dim=dim).to(x.dtype)


def _slice(x: torch.Tensor, axis: ModelAxis, dim: int) -> torch.Tensor:
    width = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * width, width).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.axis, ctx.dim), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _slice(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.axis, ctx.dim), None, None


def copy_to(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The input of a column-parallel layer: the same tensor, whose
    gradient sums the ranks' partial gradients."""
    return _CopyTo.apply(x, axis)


def reduce_from(x: torch.Tensor, axis: ModelAxis) -> torch.Tensor:
    """The sum over the model axis of each rank's partial result."""
    return _ReduceFrom.apply(x, axis)


def gather_from(x: torch.Tensor, axis: ModelAxis, dim: int = -1) -> torch.Tensor:
    """The ranks' slices concatenated along `dim`, in rank order."""
    return _GatherFrom.apply(x, axis, dim % x.ndim)


def scatter_to(x: torch.Tensor, axis: ModelAxis, dim: int = -1) -> torch.Tensor:
    """This rank's slice of a replicated tensor along `dim`."""
    return _ScatterTo.apply(x, axis, dim % x.ndim)


def local(t: torch.Tensor) -> torch.Tensor:
    """The local shard of a parameter placed by mesh.shard_params (a
    DTensor), or the tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor sharded over the model axis, gathered
    with all_gather (a collective of its group: every rank calls it); any
    other tensor is returned as it is."""
    if not hasattr(t, "to_local"):
        return t
    from torch.distributed.tensor import Shard
    out = t.to_local()
    mesh = t.device_mesh
    for mesh_dim, p in enumerate(t.placements):
        if isinstance(p, Shard):
            axis = ModelAxis(mesh.get_group(mesh_dim), mesh.get_local_rank(mesh_dim),
                             mesh.size(mesh_dim))
            out = _all_gather(out, axis, p.dim)
    return out
