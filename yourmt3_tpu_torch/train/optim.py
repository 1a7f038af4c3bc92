"""Optimizers and learning-rate schedules with optax's semantics.

Each optimizer is a gradient transformation over a name → tensor dict of
fp32 master parameters: `init(params)` → state, `update(grads, state,
params)` → (updates, state), and the caller adds the updates to the
parameters. State is a nested dict of tensors and ints, so
`torch.save`/`torch.load(weights_only=True)` round-trip it.

What follows optax exactly, and where torch's own classes differ:
- `clip_by_global_norm` rescales to clip / ‖g‖ only when ‖g‖ ≥ clip
  (torch's `clip_grad_norm_` divides by ‖g‖ + 1e-6);
- a schedule is read at the update count *before* it is incremented, so
  the cosine warmup's first update has learning rate 0;
- `adafactor` is optax's: factored second moments for parameters with
  two axes of at least 128, decay 1 - (t+1)^-0.8, update clipping at
  block RMS 1.0, parameter-scale multiplication (min 1e-3), eps 1e-30
  (torch.optim.Adafactor differs in each);
- `multi_steps` is optax.MultiSteps: the running mean of k
  micro-gradients goes to the inner optimizer every k-th call, which
  alone advances the inner schedule; the other calls return zero updates;
- `dadapt_adamw` is optax.contrib.dadapt_adamw (D-Adaptation, Defazio
  and Mishchenko 2023): Adam whose step size d is estimated from the
  gradients, the schedule a multiplier on d; torch has no counterpart.
The factored statistics are symmetric in the two factored axes, so a
torch (out, in) weight and the reference's (in, out) kernel get the same
updates.

Parameters sharded over the model axis (parallel/mesh.shard_params) come
as DTensors, and so do their gradients: each rank updates its shard, the
state takes the parameter's placement, and every sum or mean over a
tensor or over all of them (the global norm, the block RMS, the factored
statistics, D-Adaptation's sums) counts each element once, through an
all-reduce. No step gathers a shard.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..parallel.tensor_parallel import local

Params = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    init: Callable[[Params], dict]
    update: Callable[[Params, dict, Optional[Params]], Tuple[Params, dict]]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

def make_schedule(name: str, base_lr: float, warmup_steps: int = 1000,
                  total_steps: int = 100_000, final_scale: float = 0.1) -> Schedule:
    """'cosine' | 'legacy' (MT3 inverse-sqrt) | 'constant'; count → lr."""
    if name == "cosine":
        decay = max(total_steps, warmup_steps + 1) - warmup_steps
        alpha = 0.0 if base_lr == 0.0 else final_scale

        def cosine(count: int) -> float:
            if count < warmup_steps:  # linear from 0 up to base_lr
                frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
                return -base_lr * frac + base_lr
            c = min(count - warmup_steps, decay)
            return base_lr * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay))
                              + alpha)
        return cosine
    if name == "legacy":  # MT3: constant, then 1/sqrt(step) decay
        return lambda count: base_lr * math.sqrt(
            warmup_steps / max(float(count), float(warmup_steps)))
    if name == "constant":
        return lambda count: base_lr
    raise ValueError(f"unknown schedule {name!r}")


# ---------------------------------------------------------------------------
# transformations
# ---------------------------------------------------------------------------

def _whole(x: torch.Tensor) -> torch.Tensor:
    """A reduction's value as a plain tensor: a DTensor's partial sums are
    all-reduced over the model axis."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of every element (of a DTensor: of the whole tensor, as
    a sum all-reduced over the model axis, over the whole count)."""
    if hasattr(x, "full_tensor"):
        return _whole(torch.sum(x)) / x.numel()
    return torch.mean(x)


def _total(terms) -> torch.Tensor:
    """The sum of per-tensor sums (0-dim tensors, DTensors or not)."""
    return sum(_whole(t) for t in terms)


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(_total(torch.sum(t * t) for t in tree.values()))


def _stateless(fn) -> GradientTransformation:
    return GradientTransformation(lambda params: {},
                                  lambda u, state, params=None: (fn(u, params), state))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    def clip(grads, params):
        g_norm = global_norm(grads)
        keep = g_norm < max_norm
        return {k: torch.where(keep, g, (g / g_norm) * max_norm)
                for k, g in grads.items()}
    return _stateless(clip)


def clip_by_block_rms(threshold: float) -> GradientTransformation:
    def clip(updates, params):
        return {k: u / torch.clamp(torch.sqrt(_mean(u * u)) / threshold,
                                   min=1.0)
                for k, u in updates.items()}
    return _stateless(clip)


def scale(factor: float) -> GradientTransformation:
    return _stateless(lambda updates, params: {k: u * factor
                                               for k, u in updates.items()})


def scale_by_param_block_rms(min_scale: float = 1e-3) -> GradientTransformation:
    def scale_(updates, params):
        return {k: u * torch.clamp(torch.sqrt(_mean(params[k] * params[k])),
                                   min=min_scale)
                for k, u in updates.items()}
    return _stateless(scale_)


def add_decayed_weights(weight_decay: float) -> GradientTransformation:
    return _stateless(lambda updates, params: {
        k: u + weight_decay * params[k] for k, u in updates.items()})


def scale_by_schedule(step_size: Schedule) -> GradientTransformation:
    """updates · step_size(count), count advanced after the read."""
    def update(updates, state, params=None):
        lr = step_size(state["count"])
        return ({k: lr * u for k, u in updates.items()},
                {"count": state["count"] + 1})
    return GradientTransformation(lambda params: {"count": 0}, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999,
                  eps: float = 1e-8) -> GradientTransformation:
    def init(params):
        return {"count": 0,
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params=None):
        count = state["count"] + 1
        c1, c2 = 1.0 - b1 ** count, 1.0 - b2 ** count
        mu, nu, out = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1.0 - b1) * g + b1 * state["mu"][k]
            nu[k] = (1.0 - b2) * (g * g) + b2 * state["nu"][k]
            out[k] = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
        return out, {"count": count, "mu": mu, "nu": nu}
    return GradientTransformation(init, update)


def _factored_dims(shape, min_dim: int) -> Optional[Tuple[int, int]]:
    """(second-largest axis, largest axis), or None when the second
    largest is below `min_dim`."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < min_dim:
        return None
    return order[-2], order[-1]


def _shard_dim(t: torch.Tensor) -> Optional[int]:
    """The axis of `t` split over the model axis, or None."""
    from torch.distributed.tensor import Shard
    for p in getattr(t, "placements", ()):
        if isinstance(p, Shard):
            return p.dim
    return None


def _mean_over(x: torch.Tensor, dim: int, like: torch.Tensor,
               split: Optional[int]) -> torch.Tensor:
    """The mean over axis `dim` of the whole tensor whose local shard is
    `x` (split on axis `split` over like's model axis, or whole)."""
    if split != dim:
        return x.mean(dim=dim)
    s = x.sum(dim=dim)
    dist.all_reduce(s, group=like.device_mesh.get_group(0))
    return s / (x.shape[dim] * like.device_mesh.size(0))


def _placed(x: torch.Tensor, like: torch.Tensor, split: Optional[int]):
    """`x` (a local tensor) as a DTensor on like's mesh, split on axis
    `split` or replicated; `x` itself when `like` is not a DTensor."""
    if not hasattr(like, "device_mesh"):
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    return DTensor.from_local(x, like.device_mesh,
                              [Replicate() if split is None else Shard(split)],
                              run_check=False)


def _after_reduce(split: Optional[int], dim: int) -> Optional[int]:
    """The split axis once axis `dim` is reduced away."""
    if split is None or split == dim:
        return None
    return split - 1 if split > dim else split


def scale_by_factored_rms(decay_rate: float = 0.8, min_dim_size_to_factor: int = 128,
                          epsilon: float = 1e-30) -> GradientTransformation:
    """The factored statistics of a sharded parameter are computed on its
    local shard: a mean over the split axis is all-reduced, and each
    statistic stays split on the axis it keeps."""
    def init(params):
        state = {"count": 0, "v_row": {}, "v_col": {}, "v": {}}
        for k, p in params.items():
            dims = _factored_dims(p.shape, min_dim_size_to_factor)
            if dims is None:
                state["v"][k] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                split, pl = _shard_dim(p), local(p)
                state["v_row"][k] = _placed(torch.zeros_like(pl.sum(dim=d0)), p,
                                            _after_reduce(split, d0))
                state["v_col"][k] = _placed(torch.zeros_like(pl.sum(dim=d1)), p,
                                            _after_reduce(split, d1))
        return state

    def update(grads, state, params=None):
        t = float(state["count"] + 1)
        decay = 1.0 - t ** (-decay_rate)
        new = {"count": state["count"] + 1, "v_row": {}, "v_col": {}, "v": {}}
        out = {}
        for k, g in grads.items():
            dims = _factored_dims(g.shape, min_dim_size_to_factor)
            if dims is None:
                g2 = g * g + epsilon
                v = decay * state["v"][k] + (1.0 - decay) * g2
                new["v"][k] = v
                out[k] = g * v ** -0.5
                continue
            d1, d0 = dims
            split, gl = _shard_dim(g), local(g)
            g2 = gl * gl + epsilon
            row_split, col_split = _after_reduce(split, d0), _after_reduce(split, d1)
            v_row = (decay * local(state["v_row"][k])
                     + (1.0 - decay) * _mean_over(g2, d0, g, split))
            v_col = (decay * local(state["v_col"][k])
                     + (1.0 - decay) * _mean_over(g2, d1, g, split))
            new["v_row"][k] = _placed(v_row, g, row_split)
            new["v_col"][k] = _placed(v_col, g, col_split)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = _mean_over(v_row, reduced_d1, g, row_split).unsqueeze(
                reduced_d1)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            out[k] = _placed(gl * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1),
                             g, split)
        return out, new
    return GradientTransformation(init, update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return {str(i): tx.init(params) for i, tx in enumerate(txs)}

    def update(updates, state, params=None):
        new = {}
        for i, tx in enumerate(txs):
            updates, new[str(i)] = tx.update(updates, state[str(i)], params)
        return updates, new
    return GradientTransformation(init, update)


def adamw(learning_rate: Schedule, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> GradientTransformation:
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay),
                 scale_by_schedule(lambda c: -learning_rate(c)))


def adafactor(learning_rate: Schedule, min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8, clipping_threshold: float = 1.0,
              eps: float = 1e-30) -> GradientTransformation:
    return chain(scale_by_factored_rms(decay_rate, min_dim_size_to_factor, eps),
                 clip_by_block_rms(clipping_threshold),
                 scale_by_schedule(learning_rate),
                 scale_by_param_block_rms(),
                 scale(-1.0))


def dadapt_adamw(learning_rate: Schedule, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, estim_lr0: float = 1e-6,
                 weight_decay: float = 0.0) -> GradientTransformation:
    """D-Adaptation AdamW, as optax.contrib.dadapt_adamw (optax 0.2.6):
    the estimate d of the distance to the solution starts at estim_lr0
    and only grows; each update is Adam's with step d · schedule(count) ·
    bias correction, plus AdamW decay. The scalars are fp32 0-dim tensors
    as in optax, so the state round-trips through torch.save with the
    rest."""
    b1, b2 = betas
    sb2 = b2 ** 0.5

    def init(params):
        dev = next(iter(params.values())).device

        def zeros():
            return {k: torch.zeros_like(p) for k, p in params.items()}
        return {"count": 0, "exp_avg": zeros(), "exp_avg_sq": zeros(),
                "grad_sum": zeros(),
                "estim_lr": torch.tensor(estim_lr0, dtype=torch.float32, device=dev),
                "numerator_weighted": torch.zeros((), dtype=torch.float32, device=dev)}

    def update(grads, state, params=None):
        if params is None:
            raise ValueError("dadapt_adamw needs the parameters")
        count = state["count"] + 1
        estim_lr = state["estim_lr"]
        one = torch.ones((), dtype=torch.float32, device=estim_lr.device)
        bc = torch.sqrt(1 - (one * b2) ** count) / (1 - (one * b1) ** count)
        dlr = estim_lr * learning_rate(state["count"]) * bc
        numerator_acum = _total(
            torch.sum(g * (state["grad_sum"][k] / (torch.sqrt(state["exp_avg_sq"][k]) + eps)))
            for k, g in grads.items())
        exp_avg = {k: b1 * state["exp_avg"][k] + (1 - b1) * dlr * g
                   for k, g in grads.items()}
        exp_avg_sq = {k: b2 * state["exp_avg_sq"][k] + (1 - b2) * g * g
                      for k, g in grads.items()}
        grad_sum = {k: sb2 * state["grad_sum"][k] + (1 - sb2) * dlr * g
                    for k, g in grads.items()}
        grad_sum_l1 = _total(torch.sum(torch.abs(v)) for v in grad_sum.values())
        numerator_weighted = (sb2 * state["numerator_weighted"]
                              + (1 - sb2) * dlr * numerator_acum)
        d_estimate = numerator_weighted / ((1 - sb2) * grad_sum_l1)
        updates = {k: -weight_decay * dlr * params[k]
                   - exp_avg[k] / (torch.sqrt(exp_avg_sq[k]) + eps) for k in grads}
        return updates, {"count": count, "exp_avg": exp_avg, "exp_avg_sq": exp_avg_sq,
                         "grad_sum": grad_sum,
                         "estim_lr": torch.maximum(estim_lr, d_estimate),
                         "numerator_weighted": numerator_weighted}
    return GradientTransformation(init, update)


def multi_steps(inner: GradientTransformation, k: int) -> GradientTransformation:
    def init(params):
        return {"mini_step": 0, "gradient_step": 0, "inner": inner.init(params),
                "acc": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(grads, state, params=None):
        n = state["mini_step"]
        acc = {name: state["acc"][name] + (g - state["acc"][name]) / (n + 1)
               for name, g in grads.items()}
        if n == k - 1:
            updates, inner_state = inner.update(acc, state["inner"], params)
            return updates, {"mini_step": 0,
                             "gradient_step": state["gradient_step"] + 1,
                             "inner": inner_state,
                             "acc": {name: torch.zeros_like(a)
                                     for name, a in acc.items()}}
        return ({name: torch.zeros_like(g) for name, g in grads.items()},
                {**state, "mini_step": n + 1, "acc": acc})
    return GradientTransformation(init, update)


def make_optimizer(name: str = "adamw", base_lr: float = 1e-3,
                   schedule: str = "cosine", warmup_steps: int = 1000,
                   total_steps: int = 100_000, weight_decay: float = 0.0,
                   grad_clip: Optional[float] = 1.0,
                   grad_accum_steps: int = 1) -> GradientTransformation:
    """The reference's optimizer choices; grad_accum_steps > 1 wraps the
    optimizer in `multi_steps`."""
    sched = make_schedule(schedule, base_lr, warmup_steps, total_steps)
    if name == "adamw":
        core = adamw(sched, weight_decay=weight_decay)
    elif name == "adafactor":
        core = adafactor(sched)
    elif name == "dadapt_adam":  # the schedule scales the estimated step
        core = dadapt_adamw(sched)
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    if grad_clip:
        core = chain(clip_by_global_norm(grad_clip), core)
    if grad_accum_steps > 1:
        core = multi_steps(core, grad_accum_steps)
    return core
