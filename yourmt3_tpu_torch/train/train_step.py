"""Training and eval-loss steps: teacher-forced CE with pad masking.

The frontend (and SpecAugment, and the pitch shift) runs inside the step,
so raw audio is what crosses from the host. The model's parameters are
the fp32 master weights; `QuantDense` casts them to the compute dtype
(bf16 for the presets) for each product, so the backward pass yields
fp32 gradients. The optimizer (train/optim.py) turns them into updates
that are added to the parameters in place. With parameters sharded over
a mesh's model axis (parallel/mesh.shard_params) the gradients, the
updates and the optimizer state are the ranks' shards.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..models.ymt3 import YMT3, ce_loss, ce_sums, shift_right
from ..ops.frontend import SpectrogramFrontend
from ..parallel import mesh as pmesh
from ..parallel.tensor_parallel import local
from .optim import GradientTransformation, Params, global_norm


@dataclasses.dataclass
class TrainState:
    """The update count and the optimizer state; the parameters live in
    the model."""

    step: int
    opt_state: dict


def trainable_params(model: YMT3) -> Dict[str, torch.nn.Parameter]:
    return dict(model.named_parameters())


def create_train_state(model: YMT3, tx: GradientTransformation) -> TrainState:
    with torch.no_grad():
        return TrainState(0, tx.init({k: p.detach()
                                      for k, p in trainable_params(model).items()}))


def _device_batch(batch, device) -> Tuple[torch.Tensor, torch.Tensor]:
    audio = torch.as_tensor(np.asarray(batch["audio"], np.float32)).to(device)
    labels = torch.as_tensor(np.asarray(batch["labels"])).to(device).long()
    return audio, labels


def make_train_step(model: YMT3, frontend: SpectrogramFrontend,
                    tx: GradientTransformation, augment_fn: Optional[Callable] = None,
                    label_smoothing: float = 0.0, pitch_shift_semitones=None,
                    grad_clip: float = 1.0,
                    shift_id_range: Optional[Tuple[int, int]] = None,
                    group=None, grad_accum_steps: int = 1):
    """→ train_step(state, batch, gen) -> (state, metrics).

    batch: {"audio": (B, input_frames) f32, "labels": (B, C, L) int,
    optional "pitch_shift_idx": (B,) selecting a semitone from
    `pitch_shift_semitones` (labels are shifted on the host)}. `gen` is a
    torch.Generator on the model's device: it draws the SpecAugment masks
    and the dropout masks: every rank of the data axis passes a generator
    in the same state, and each draws the masks of the global batch and
    keeps its own rows, so the masks are those of one process whatever the
    world size. Metrics are 0-dim device tensors (no host
    synchronisation inside the step): loss, accuracy, grad_norm (before
    clipping), grad_norm_postclip and, with `shift_id_range` (the codec's
    [lo, hi) shift-token ids), shift_accuracy and shift_accuracy_50ms
    (predicted shift within ±5 bins, the 50 ms onset tolerance).

    group: a torch.distributed process group. The model runs under
    DistributedDataParallel over it, `batch` is this rank's shard of the
    global batch, and the step computes what the JAX package's step
    computes on the global batch: the loss is the token mean over the
    whole batch (each rank's masked sum is scaled by world / the
    all-reduced token count, so DDP's average of the gradients is the
    gradient of that mean), the metrics are global, and clipping acts on
    the all-reduced gradients. With grad_accum_steps = k > 1 (tx wrapped
    in `multi_steps(., k)`) the k - 1 steps that apply no update run
    under `no_sync`: their gradients add up in `.grad` on each rank, the
    optimizer is fed zeros for them, and the k-th step's all-reduce
    brings the sum, which it is fed; its running mean then equals the
    mean of the k global micro-gradients. On those k - 1 steps the
    metrics hold no grad_norm; on the k-th, grad_norm is the norm of the
    summed micro-gradients over k (their mean). `train_step.flush(state)`
    folds gradients still pending in `.grad` into the optimizer state
    (before a checkpoint).

    group may also be a 2-D DeviceMesh (parallel/mesh.make_mesh): the
    batch is this rank's shard over the `data` axis and the gradients are
    averaged over that axis alone. With a `model` axis above 1 (the
    parameters placed by mesh.shard_params) that average is one
    all-reduce of every gradient's local shard, not DDP, and the ranks of
    one data row draw the same masks and slice the model axis's features
    as well."""
    params = trainable_params(model)
    names = list(params)
    dev = model.shared.weight.device
    tensor_parallel = (group is not None and pmesh.is_mesh(group)
                       and group[pmesh.MODEL_AXIS].size() > 1)
    group = pmesh.data_group(group) if group is not None else None
    world = 1 if group is None else dist.get_world_size(group)
    shard = (0 if group is None else dist.get_rank(group), world)
    net = model
    if group is not None and not tensor_parallel:
        net = DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            process_group=group)
    accumulate = group is not None and grad_accum_steps > 1

    def reduce_grads() -> None:
        """DDP's average over the data axis, for sharded parameters: one
        all-reduce of every gradient's local shard, flattened."""
        if world == 1:
            return
        grads = [local(params[k].grad) for k in names if params[k].grad is not None]
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=group)
        flat /= world
        for g, r in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
            g.copy_(r)

    def take_grads() -> Params:
        out = {}
        for k in names:
            g = params[k].grad
            out[k] = torch.zeros_like(params[k]) if g is None else g
            params[k].grad = None
        return out

    def train_step(state: TrainState, batch, gen: Optional[torch.Generator]):
        model.train()
        model.set_dropout_generator(gen, shard)
        audio, labels = _device_batch(batch, dev)
        with torch.no_grad():
            if pitch_shift_semitones is not None and "pitch_shift_idx" in batch:
                from ..ops.pitchshift import batched_pitch_shift
                audio = batched_pitch_shift(
                    audio, torch.as_tensor(np.asarray(batch["pitch_shift_idx"])),
                    tuple(pitch_shift_semitones))
            feats = frontend(audio)
            if augment_fn is not None:
                feats = augment_fn(gen, feats, shard=shard)
        applies = not accumulate or state.opt_state["mini_step"] == grad_accum_steps - 1
        with contextlib.nullcontext() if applies or tensor_parallel else net.no_sync():
            logits = net(feats, shift_right(labels))
            nll, correct, count = ce_sums(logits, labels, label_smoothing)
            sums = [nll.detach(), correct, count]
            if shift_id_range is not None:
                lo, hi = shift_id_range
                pred = logits.detach().argmax(-1)
                sm = ((labels >= lo) & (labels < hi)).to(torch.float32)
                near = ((pred - labels).abs() <= 5) & (pred >= lo) & (pred < hi)
                sums += [((pred == labels).to(torch.float32) * sm).sum(), sm.sum(),
                         (near.to(torch.float32) * sm).sum()]
            sums = torch.stack(sums)
            if group is not None:
                dist.all_reduce(sums, group=group)
            denom = torch.clamp(sums[2], min=1.0)
            (nll / denom * world).backward()
        with torch.no_grad():
            metrics = {"loss": sums[0] / denom, "accuracy": sums[1] / denom}
            if not applies:
                grads = {k: torch.zeros_like(params[k]) for k in names}
            else:
                if tensor_parallel:
                    reduce_grads()
                grads = take_grads()
                gnorm = global_norm(grads)
                if accumulate:
                    gnorm = gnorm / grad_accum_steps
                metrics.update(grad_norm=gnorm, grad_norm_postclip=(
                    torch.clamp(gnorm, max=grad_clip) if grad_clip else gnorm))
            current = {k: params[k].detach() for k in names}
            updates, opt_state = tx.update(grads, state.opt_state, current)
            for k in names:
                current[k].add_(updates[k])
            if shift_id_range is not None:
                sd = torch.clamp(sums[4], min=1.0)
                metrics["shift_accuracy"] = sums[3] / sd
                metrics["shift_accuracy_50ms"] = sums[5] / sd
        return TrainState(state.step + 1, opt_state), metrics

    @torch.no_grad()
    def flush(state: TrainState) -> TrainState:
        n = state.opt_state["mini_step"] if accumulate else 0
        if n == 0:
            return state
        acc = state.opt_state["acc"]
        for k, g in take_grads().items():
            dist.all_reduce(local(g), group=group)
            acc[k] += g / (world * n)
        return state

    train_step.flush = flush
    return train_step


def make_eval_loss_step(model: YMT3, frontend: SpectrogramFrontend):
    """→ eval_step(batch) -> {"loss", "accuracy"} without dropout."""

    @torch.no_grad()
    def eval_step(batch):
        model.eval()
        audio, labels = _device_batch(batch, model.shared.weight.device)
        logits = model(frontend(audio), shift_right(labels))
        loss, acc = ce_loss(logits, labels)
        return {"loss": loss, "accuracy": acc}

    return eval_step
