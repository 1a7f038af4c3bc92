"""Training loop: batches → train step → logging → checkpoints → eval.

Step loop with JSONL + console metric logging, periodic checkpoints
("last"), resume (optimizer state and step counter, so the schedule
continues), a final checkpoint on preemption, and seeded randomness (one
torch.Generator on the model's device draws SpecAugment and dropout).

Data parallel: inside an initialised process group
(parallel/mesh.init_data_parallel, e.g. under torchrun) every rank runs
this loop on the same global batches, takes its shard and steps a
DistributedDataParallel model (train_step.make_train_step); rank 0 alone
writes logs and checkpoints.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..api import ModelBundle
from ..ops.specaugment import SpecAugmentConfig, make_augment_fn
from ..parallel import mesh
from .checkpoint import read_meta, restore_opt_state, save_bundle
from .optim import make_optimizer
from .train_step import TrainState, create_train_state, make_train_step


class MetricLogger:
    """JSONL + console logger, with optional W&B mirroring (pass
    use_wandb=True with wandb installed)."""

    def __init__(self, log_dir: str, name: str = "train",
                 use_wandb: bool = False, wandb_project: str = "yourmt3_tpu"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}_log.jsonl")
        self._f = open(self.path, "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb
                wandb.init(project=wandb_project, name=name, dir=log_dir)
            except ImportError:
                print("wandb not installed; logging to JSONL only")

    def log(self, step: int, metrics: Dict[str, Any], prefix: str = "") -> None:
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            rec[f"{prefix}{k}"] = float(v) if np.isscalar(v) or hasattr(v, "item") else v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in rec.items() if k != "step"}, step=step)

    def close(self):
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


class _NoLogger:
    """The logger of ranks other than 0."""

    def log(self, step, metrics, prefix=""):
        pass

    def close(self):
        pass


def train(
    bundle: ModelBundle,
    batch_iter: Iterator[Dict[str, np.ndarray]],
    total_steps: int = 1000,
    log_every: int = 50,
    ckpt_every: int = 500,
    ckpt_dir: str = "checkpoints",
    optimizer: str = "adamw",
    base_lr: float = 1e-3,
    schedule: str = "cosine",
    warmup_steps: int = 100,
    grad_accum_steps: int = 1,
    spec_augment: bool = True,
    pitch_shift_semitones=None,  # must match the dataset's setting
    n_data_shards: Optional[int] = None,
    seed: int = 0,
    logger: Optional[MetricLogger] = None,
    eval_fn=None,
    eval_every: int = 0,
    resume_from: Optional[str] = None,
) -> ModelBundle:
    """Run the loop on the bundle's device; → the bundle, trained in place
    and left in eval() mode.

    resume_from: a checkpoint directory written by this loop; its
    optimizer state and step counter are restored, so the schedule
    continues (the weights are expected in `bundle` already, e.g. from
    `api.load_checkpoint`).

    n_data_shards: the ranks over which each global batch is split, as in
    the JAX package; it must equal the size of the process group (1
    without one), and defaults to it; a global batch that does not split
    over the ranks raises in mesh.shard_batch. Inside an initialised group
    the model trains under DDP, even at world 1."""
    group = mesh.data_group()
    world, rank = mesh.world_size(group), mesh.rank(group)
    if n_data_shards is None:
        n_data_shards = world
    if n_data_shards != world:
        raise ValueError(
            f"n_data_shards={n_data_shards} but the process group has {world} "
            "ranks: start one process per shard (torchrun) with a global batch "
            "that splits over them")
    tx = make_optimizer(optimizer, base_lr, schedule, warmup_steps, total_steps,
                        grad_accum_steps=grad_accum_steps)
    aug = make_augment_fn(SpecAugmentConfig()) if spec_augment else None
    codec = bundle.task_manager.codec
    shift_lo = codec.offset_of("shift")
    model = bundle.model
    step_fn = make_train_step(model, bundle.frontend, tx, augment_fn=aug,
                              pitch_shift_semitones=pitch_shift_semitones,
                              shift_id_range=(shift_lo,
                                              shift_lo + codec.max_shift_steps + 1),
                              group=group, grad_accum_steps=grad_accum_steps)
    state = create_train_state(model, tx)
    start_step = 0
    if resume_from:
        saved = restore_opt_state(resume_from, bundle.device)
        if saved is not None:
            start_step = int(saved["step"])
            state = TrainState(start_step, saved["opt_state"])
        elif int(read_meta(resume_from).get("step", 0)) > 0:
            # fast-forwarding the loop while the schedule restarts at 0
            # would be an inconsistent hybrid: refuse
            raise ValueError(
                f"{resume_from} records a step but holds no optimizer state: "
                "resume from a checkpoint written by train(), or start a "
                "fresh run from these weights")
        if rank == 0:
            print(f"resuming at step {start_step} from {resume_from}")
    # one stream on every rank: each draws the global batch's masks
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    own_logger = logger is None and rank == 0
    if rank:
        logger = _NoLogger()
    logger = logger or MetricLogger(ckpt_dir)

    from ..utils.preemption import PreemptionGuard
    guard = PreemptionGuard.instance()
    guard.install()

    def save(step):
        nonlocal state
        state = step_fn.flush(state)
        if rank == 0:
            save_bundle(last, bundle, step, opt_state=state.opt_state)

    def preempted() -> bool:  # every rank must stop at the same step
        if world == 1:
            return guard.preempted
        flag = torch.tensor([float(guard.preempted)], device=bundle.device)
        torch.distributed.all_reduce(flag, op=torch.distributed.ReduceOp.MAX,
                                     group=group)
        return bool(flag.item())

    last = os.path.join(ckpt_dir, "last")
    t0 = time.perf_counter()
    tokens_seen = 0
    try:
        for step in range(start_step + 1, total_steps + 1):
            if preempted():
                # step N has not run: the weights hold N-1 completed
                # updates, so record N-1 and a resume re-runs step N
                if rank == 0:
                    print(f"preemption before step {step}: writing final checkpoint")
                save(step - 1)
                break
            batch = next(batch_iter)
            tokens_seen += int((np.asarray(batch["labels"]) != 0).sum())
            state, metrics = step_fn(state, mesh.shard_batch(batch, group), gen)
            if step % log_every == 0 or step == total_steps:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                m["steps_per_sec"] = (step - start_step) / dt
                m["target_tokens_per_sec"] = tokens_seen / dt
                logger.log(step, m)
                sh = (f" shift={m['shift_accuracy']:.3f}"
                      if "shift_accuracy" in m else "")
                if rank == 0:
                    print(f"step {step}: loss={m['loss']:.4f} acc={m['accuracy']:.4f}"
                          f"{sh} ({m['steps_per_sec']:.2f} it/s)")
            if ckpt_every and (step % ckpt_every == 0 or step == total_steps):
                save(step)
            if eval_fn is not None and eval_every and step % eval_every == 0:
                model.eval()
                logger.log(step, eval_fn(bundle), prefix="eval/")
    finally:
        model.eval()
        model.set_dropout_generator(None)
        if own_logger:
            logger.close()
    return bundle
