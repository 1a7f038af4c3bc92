"""The check of a training window's first steps against the plain
reference.

The reference starts from the same seeded weights, takes the same
batches, draws the same SpecAugment and dropout masks from a generator
seeded as the trainer seeds its own, and runs each step in float32 (TF32
off) in blocks of rows: features, masks, teacher-forced loss (the token
mean over the whole batch), backward, global-norm clipping, Adam with the
configuration's schedule. Three numbers are compared, each the worst of
its kind:

- `loss_gap`: |program − reference| / reference, over the checked steps;
- `grad_gap`: per parameter, the gap between the norms of the first
  gradient as the optimizer gets it (the program's: Adam's first moment
  after step 1 over 1 − b1) over the larger of the reference's norm and
  the median parameter's;
- `change_gap`: the same for the change of each parameter over the
  checked steps, leaving out the parameters whose first reference
  gradient is under a thousandth of the median parameter's (they move by
  Adam's round-off alone).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from harness import weights
from reference import model as ref

QUIET_GRAD = 1e-3


def reference_steps(config: dict, seed: int, batches: List[dict], device,
                    rows_per_block: int, num: ref.Numerics = ref.FP32,
                    half_batch: bool = False) -> dict:
    """→ {"losses", "g1", "params0", "params"} after len(batches) steps.
    half_batch plants a fault: the loss is the mean over the first half of
    each batch's rows only."""
    cfg, acfg, tr = config["model"], config["audio"], config["train"]
    ref.fp32_flags()
    p0 = weights.for_config(config, ref.param_shapes(config), seed, device)
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p0.items()}
    nu = {k: torch.zeros_like(v) for k, v in p0.items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    b1, b2, eps = tr["adam_b1"], tr["adam_b2"], tr["adam_eps"]
    losses, g1 = [], None
    for step, batch in enumerate(batches, 1):
        audio = torch.from_numpy(np.asarray(batch["audio"], np.float32)).to(device)
        labels = torch.from_numpy(np.asarray(batch["labels"])).to(device).long()
        B = audio.shape[0]
        with torch.no_grad():
            feats = ref.features(audio, acfg)
            if tr["spec_augment"]:
                m = ref.spec_augment_masks(gen, B, feats.shape[1], feats.shape[2], device)
                feats = torch.where(m, feats.mean(dim=(1, 2), keepdim=True), feats)
        drop = ref.MaskSource(gen, cfg["dropout_rate"], B)
        rows = B // 2 if half_batch else B
        count = torch.clamp((labels[:rows] != 0).sum().to(torch.float32), min=1.0)
        total = torch.zeros((), device=device)
        for r0 in range(0, B, rows_per_block):
            r1 = min(B, r0 + rows_per_block)
            drop.block(r0, r1)
            lg = ref.logits(p, None, labels[r0:r1], config, num=num, drop=drop,
                            feats=feats[r0:r1])
            keep = labels[r0:r1] * (torch.arange(r0, r1, device=device) < rows)[:, None, None]
            nll, _ = ref.token_nll(lg, keep)
            (nll / count).backward()
            total = total + nll.detach()
        losses.append(float(total / count))
        with torch.no_grad():
            grads = {k: v.grad for k, v in p.items()}
            grads = ref.global_clip(grads, tr["grad_clip"])
            if step == 1:
                g1 = {k: g.clone() for k, g in grads.items()}
            lr = ref.cosine_lr(step - 1, tr["base_lr"], tr["warmup_steps"],
                               tr["total_steps"])
            c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
            for k, v in p.items():
                mu[k] = (1.0 - b1) * grads[k] + b1 * mu[k]
                nu[k] = (1.0 - b2) * grads[k] * grads[k] + b2 * nu[k]
                upd = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
                v -= lr * (upd + tr["weight_decay"] * v)
                v.grad = None
    return {"losses": losses, "g1": g1, "params0": p0,
            "params": {k: v.detach() for k, v in p.items()}}


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in tree.items()}


def worst_leaf(got: Dict[str, float], want: Dict[str, float], keep=None,
               note: Optional[list] = None) -> float:
    floor = float(np.median(list(want.values())))
    gaps = {k: abs(got[k] - want[k]) / max(want[k], floor)
            for k in want if keep is None or k in keep}
    worst = max(gaps, key=gaps.get)
    if note is not None:
        note.append((worst, want[worst], floor))
    return gaps[worst]


def compare(program: dict, reference: dict, b1: float,
            notes: Optional[dict] = None) -> Dict[str, float]:
    """program: {"losses", "mu1" (Adam's first moment after step 1),
    "params" (after the checked steps)}; reference: reference_steps'.
    `notes` receives, per number, the worst parameter, its reference norm
    and the median's."""
    want_l = reference["losses"]
    loss = max(abs(a - b) / abs(b) for a, b in zip(program["losses"], want_l))
    g_ref = _norms(reference["g1"])
    g_prog = _norms({k: v / (1.0 - b1) for k, v in program["mu1"].items()})
    p0 = reference["params0"]
    d_ref = _norms({k: reference["params"][k] - p0[k] for k in p0})
    d_prog = _norms({k: program["params"][k] - p0[k] for k in p0})
    med = float(np.median(list(g_ref.values())))
    moved = {k for k, v in g_ref.items() if v >= QUIET_GRAD * med}
    g_note, d_note = [], []
    out = {"loss_gap": loss, "grad_gap": worst_leaf(g_prog, g_ref, note=g_note),
           "change_gap": worst_leaf(d_prog, d_ref, moved, note=d_note)}
    if notes is not None:
        notes.update(grad_gap=g_note[0], change_gap=d_note[0],
                     quiet=sorted(set(g_ref) - moved))
    return out


def check(config: dict, seed: int, batches: List[dict], program: dict, device,
          traffic: dict, limits: dict, control: Optional[ref.Numerics] = None,
          notes: Optional[dict] = None) -> dict:
    reference = reference_steps(config, seed, batches, device,
                                traffic["ref_rows_per_block"])
    b1 = config["train"]["adam_b1"]
    got = compare(program, reference, b1, notes)
    out = {k: {"value": v, "limit": limits[k]} for k, v in got.items()}
    if control is not None:  # readings for the limits: the control, a fault
        for tag, kw in (("control_", {"num": control}),
                        ("half_batch_", {"half_batch": True})):
            other = reference_steps(config, seed, batches, device,
                                    traffic["ref_rows_per_block"], **kw)
            as_program = {"losses": other["losses"], "params": other["params"],
                          "mu1": {k: (1.0 - b1) * g for k, g in other["g1"].items()}}
            for k, v in compare(as_program, reference, b1).items():
                out[tag + k] = {"value": v, "limit": limits[k]}
    return out
