"""Training and eval-loss steps: teacher-forced CE with pad masking.

The frontend (and SpecAugment, and the pitch shift) runs inside the step,
so raw audio is what crosses from the host. The model's parameters are
the fp32 master weights; `QuantDense` casts them to the compute dtype
(bf16 for the presets) for each product, so the backward pass yields
fp32 gradients. The optimizer (train/optim.py) turns them into updates
that are added to the parameters in place.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.ymt3 import YMT3, ce_loss, shift_right
from ..ops.frontend import SpectrogramFrontend
from .optim import GradientTransformation, global_norm


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
                    shift_id_range: Optional[Tuple[int, int]] = None):
    """→ train_step(state, batch, gen) -> (state, metrics).

    batch: {"audio": (B, input_frames) f32, "labels": (B, C, L) int,
    optional "pitch_shift_idx": (B,) selecting a semitone from
    `pitch_shift_semitones` (labels are shifted on the host)}. `gen` is a
    torch.Generator on the model's device: it draws the SpecAugment masks
    and the dropout masks. Metrics are 0-dim device tensors (no host
    synchronisation inside the step): loss, accuracy, grad_norm (before
    clipping), grad_norm_postclip and, with `shift_id_range` (the codec's
    [lo, hi) shift-token ids), shift_accuracy and shift_accuracy_50ms
    (predicted shift within ±5 bins, the 50 ms onset tolerance)."""
    params = trainable_params(model)
    names = list(params)

    def train_step(state: TrainState, batch, gen: Optional[torch.Generator]):
        model.train()
        model.set_dropout_generator(gen)
        audio, labels = _device_batch(batch, model.shared.weight.device)
        with torch.no_grad():
            if pitch_shift_semitones is not None and "pitch_shift_idx" in batch:
                from ..ops.pitchshift import batched_pitch_shift
                audio = batched_pitch_shift(
                    audio, torch.as_tensor(np.asarray(batch["pitch_shift_idx"])),
                    tuple(pitch_shift_semitones))
            feats = frontend(audio)
            if augment_fn is not None:
                feats = augment_fn(gen, feats)
        logits = model(feats, shift_right(labels))
        loss, acc = ce_loss(logits, labels, label_smoothing)
        grads = torch.autograd.grad(loss, [params[k] for k in names],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        with torch.no_grad():
            current = {k: params[k].detach() for k in names}
            updates, opt_state = tx.update(grads, state.opt_state, current)
            for k in names:
                current[k].add_(updates[k])
            gnorm = global_norm(grads)
            metrics = {"loss": loss.detach(), "accuracy": acc, "grad_norm": gnorm,
                       "grad_norm_postclip": (torch.clamp(gnorm, max=grad_clip)
                                              if grad_clip else gnorm)}
            if shift_id_range is not None:
                lo, hi = shift_id_range
                pred = logits.argmax(-1)
                sm = ((labels >= lo) & (labels < hi)).to(torch.float32)
                denom = torch.clamp(sm.sum(), min=1.0)
                hit = (pred == labels).to(torch.float32)
                metrics["shift_accuracy"] = (hit * sm).sum() / denom
                near = ((pred - labels).abs() <= 5) & (pred >= lo) & (pred < hi)
                metrics["shift_accuracy_50ms"] = (near.to(torch.float32) * sm).sum() / denom
        return TrainState(state.step + 1, opt_state), metrics

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
