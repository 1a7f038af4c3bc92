"""D-Adaptation Adam: the port's `make_optimizer("dadapt_adam", ...)`
against the JAX package's (optax.contrib.dadapt_adamw) on a small
parameter tree, with and without global-norm clipping and gradient
accumulation, and its state through torch.save.

Both sides minimise the same quadratic from the same start, each taking
its gradient at its own parameters, so D-Adaptation's estimate of the
step size grows as it does in training."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from yourmt3_tpu.train.optim import make_optimizer as jax_make_optimizer
from yourmt3_tpu_torch.train import optim

from torch_port_util import one_intra_op_thread  # noqa: F401

SHAPES = {"dense": (64, 32), "conv": (8, 4, 3, 3), "vec": (32,)}
STEPS = 20
# (name, base_lr: the multiplier on the estimated step, schedule, warmup,
# total steps). A schedule that is 0 at count 0, as the cosine warmup is,
# leaves the first gradient sum at 0 and the first estimate 0 / 0 = NaN in
# optax and in the port alike (ROADMAP Queue 3), so the cases run the
# constant and the legacy schedule
CASES = {"plain": (("dadapt_adam", 1.0, "constant", 2, STEPS), dict(grad_clip=None)),
         "clip": (("dadapt_adam", 1.0, "legacy", 4, STEPS), dict(grad_clip=1.0)),
         "clip_accum2": (("dadapt_adam", 1.0, "constant", 2, STEPS),
                         dict(grad_clip=1.0, grad_accum_steps=2))}
# fp32 on both sides; the sums over the tree (the numerator and the L1
# norm of the gradient sum) are taken in another order, so the estimate d
# is one rounding apart after the first update (1.1e-7 relative), and d
# grows by about 1.5x per step from its own past: that difference grows to
# 1.6e-5 by step 20, and the weights follow it to 2.2e-6 (the plain case).
# Each tensor is held by ||port - optax|| / ||optax||.
TOL_REL = 1e-5


def problem():
    rng = np.random.default_rng(0)
    start = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in SHAPES.items()}
    target = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    return start, target


def run_port(tx, start, target, steps, state=None, params=None):
    params = params or {k: torch.from_numpy(v.copy()) for k, v in start.items()}
    state = state if state is not None else tx.init(params)
    for _ in range(steps):
        grads = {k: 2.0 * (p - torch.from_numpy(target[k])) for k, p in params.items()}
        updates, state = tx.update(grads, state, params)
        params = {k: params[k] + updates[k] for k in params}
    return params, state


def run_jax(tx, start, target, steps):
    params = {k: jnp.asarray(v) for k, v in start.items()}
    target = {k: jnp.asarray(v) for k, v in target.items()}

    @jax.jit
    def step(params, state):
        grads = {k: 2.0 * (p - target[k]) for k, p in params.items()}
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    state = tx.init(params)
    for _ in range(steps):
        params, state = step(params, state)
    return params, state


def _estim_lr(state):
    """D-Adaptation's estimate inside the port's state chain."""
    if "inner" in state:
        state = state["inner"]
    return state["1"]["estim_lr"] if "1" in state else state["estim_lr"]


@pytest.mark.parametrize("case", list(CASES))
def test_dadapt_adam_matches_optax(case):
    start, target = problem()
    args, kw = CASES[case]
    jp, _ = run_jax(jax_make_optimizer(*args, **kw), start, target, STEPS)
    pp, ps = run_port(optim.make_optimizer(*args, **kw), start, target, STEPS)
    for k in SHAPES:
        want = np.asarray(jp[k])
        err = np.linalg.norm(pp[k].numpy() - want) / np.linalg.norm(want)
        assert err <= TOL_REL, (case, k, err)
        # steps of estim_lr0 = 1e-6 would move the weights by ~2e-5
        moved = np.abs(want - start[k]).max()
        assert moved > 1e-4, (case, k, moved)
    assert float(_estim_lr(ps)) > 1e-5


def test_dadapt_adam_state_round_trips_through_torch_save():
    """Ten steps, the state saved and loaded as a checkpoint loads it,
    ten more: the same weights as twenty steps in one go."""
    start, target = problem()
    tx = optim.make_optimizer(*CASES["clip"][0], grad_clip=1.0)
    want, _ = run_port(tx, start, target, STEPS)
    params, state = run_port(tx, start, target, STEPS // 2)
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    state = torch.load(buf, weights_only=True)
    got, _ = run_port(tx, start, target, STEPS - STEPS // 2, state=state, params=params)
    for k in SHAPES:
        assert torch.equal(got[k], want[k]), k
