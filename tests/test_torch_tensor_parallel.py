"""The port's tensor parallelism over the `model` axis against the JAX
package's (parallel/mesh.py `_param_spec`/`shard_params` and its train
step under GSPMD on the virtual 8-device CPU mesh), and against the
port's own one-process step.

- Placement: every parameter of each preset at full width gets the
  placement JAX's `_param_spec` gives its counterpart on a model axis of
  2 (non-dividing tensors replicated), mapped from flax's (in, out) to
  torch's (out, in).
- Training: gloo ranks on the CPU (tests/torch_parallel_util.py) train
  at (data, model) = (1, 2) and (2, 2) in fp32 from weights bridged from
  JAX; the losses and weights after two AdamW steps are held to JAX's
  step at the same layout and to the port's one-process step. A dropout
  and SpecAugment case, AdaFactor, D-Adaptation, the conformer (its
  GLU's gathered input, its FFN's sliced dropout mask), GQA with local
  kv heads and MQA on whole features are held to the port's one-process
  step, which must draw the same masks.
- A sharded model's checkpoint restores in one process.

Every weight tensor is held by its relative error (`check_weights`) at
TOL_WEIGHT_REL, except where the MoE flagship's bf16 group projection
makes the tensors upstream of it sensitive to the order of fp32 sums
(TOL_ORDER_SENSITIVE); the same model with that projection in fp32 holds
TOL_WEIGHT_REL everywhere."""

import re
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yourmt3_tpu.api import ModelBundle as JaxModelBundle
from yourmt3_tpu.config.audio import AudioConfig as JaxAudioConfig
from yourmt3_tpu.config.model import get_model_config as jax_model_config
from yourmt3_tpu.models.ymt3 import YMT3 as JaxYMT3
from yourmt3_tpu.ops.frontend import SpectrogramFrontend as JaxFrontend
from yourmt3_tpu.parallel.mesh import _param_spec
from yourmt3_tpu.parallel.mesh import make_mesh as jax_make_mesh
from yourmt3_tpu.parallel.mesh import shard_batch as jax_shard_batch
from yourmt3_tpu.parallel.mesh import shard_params as jax_shard_params
from yourmt3_tpu.tokens.task_manager import TaskManager as JaxTaskManager
from yourmt3_tpu.train.optim import make_optimizer as jax_make_optimizer
from yourmt3_tpu.train.train_step import create_train_state as jax_create_state
from yourmt3_tpu.train.train_step import make_train_step as jax_make_step
from yourmt3_tpu_torch.api import load_checkpoint
from yourmt3_tpu_torch.config.audio import AudioConfig
from yourmt3_tpu_torch.config.model import get_model_config
from yourmt3_tpu_torch.models.ymt3 import YMT3
from yourmt3_tpu_torch.parallel.mesh import param_spec
from yourmt3_tpu_torch.tokens.task_manager import TaskManager
from yourmt3_tpu_torch.weights import INVERSE_RULES, flatten_params, state_dict_from_jax

from torch_parallel_util import FP32, SMALL, run_ranks, tp_bundle, tp_job, tp_steps
from torch_parallel_util import check_weights as util_check_weights
from torch_port_util import numpy_params, one_intra_op_thread  # noqa: F401

TINY_MOE = dict(d_model=64, d_kv=16, num_heads=4, d_ff=128, num_decoder_layers=2,
                ptf_num_latents=26, ptf_d_latent=32, ptf_num_blocks=1,
                ptf_num_moe_experts=4)
TINY_PTF = {k: v for k, v in TINY_MOE.items() if k != "ptf_num_moe_experts"}
TINY_CONFORMER = dict(d_model=64, d_kv=16, num_heads=4, d_ff=128, num_encoder_layers=1,
                      num_decoder_layers=1)
MODELS = {"t5_tiny": ("t5_tiny", "mt3_full_plus_256", {}),
          "moe_flagship": ("perceiver_tf_mc13_moe", "mc13_full_plus_256", TINY_MOE),
          "t5_wide": ("t5_tiny", "mt3_full_plus_256", dict(d_model=128, d_ff=256)),
          "conformer": ("conformer_small", "mt3_full_plus_256", TINY_CONFORMER),
          # decoder heads 4: kv heads 2 split into one local kv head for
          # two local query heads; 1 kv head does not split (whole features)
          "gqa": ("perceiver_tf_mc13_gqa2", "mc13_full_plus_256", TINY_PTF),
          "mqa": ("perceiver_tf_mc13_mqa", "mc13_full_plus_256", TINY_PTF)}
# name: (model, optimizer, lr, dropout, SpecAugment, layouts, against JAX,
# group projection in fp32 (see sensitive_tensors))
CASES = {
    "t5_tiny": ("t5_tiny", "adamw", 1e-3, 0.0, False, ((1, 2), (2, 2)), True, False),
    "moe_flagship": ("moe_flagship", "adamw", 1e-4, 0.0, False, ((1, 2), (2, 2)), True,
                     False),
    "moe_fp32_projection": ("moe_flagship", "adamw", 1e-4, 0.0, False, ((1, 2),), False,
                            True),
    "t5_dropout": ("t5_tiny", "adamw", 1e-3, 0.1, True, ((1, 2),), False, False),
    "t5_adafactor": ("t5_wide", "adafactor", 1e-3, 0.0, False, ((1, 2),), False, False),
    "t5_dadapt": ("t5_tiny", "dadapt_adam", 1.0, 0.0, False, ((1, 2),), False, False),
    "conformer_dropout": ("conformer", "adamw", 1e-3, 0.1, True, ((1, 2),), False, False),
    "gqa": ("gqa", "adamw", 1e-3, 0.0, False, ((1, 2),), False, True),
    "mqa": ("mqa", "adamw", 1e-3, 0.0, False, ((1, 2),), False, True),
}
# the models whose weights come from JAX (every other starts from the
# port's seed-0 init)
JAX_MODELS = {c[0] for c in CASES.values() if c[6]}
STEPS = 2
TOL_LOSS_REL = 1e-5
TOL_WEIGHT_REL = 1e-4
# bf16's unit roundoff: the order-sensitive tensors' gradients reach them
# through a gradient rounded to bf16 (sensitive_tensors)
TOL_ORDER_SENSITIVE = 2.0 ** -9
# the share of a case's weights that may lie in the rounding band
# (check_weights)
BAND_MAX = 1e-2
# non-pad tokens of the rows of a global batch: the data shards of (2, 2)
# hold different token counts
NON_PAD = (200, 150, 40, 25)
# placement presets at full width, and JAX's counts on a model axis of 2:
# (column P(None, model), row P(model, None), replicated, expert P(model))
FULL_WIDTH = {
    "t5_small": ("mt3_full_plus", (105, 40, 46, 0)),
    "perceiver_tf_mc13": ("mc13_full_plus_256", (93, 38, 65, 0)),
    "perceiver_tf_mc13_moe": ("mc13_full_plus_256", (87, 32, 71, 12)),
    "perceiver_tf_mc13_mqa": ("mc13_full_plus_256", None),
    "perceiver_tf_mc13_gqa2": ("mc13_full_plus_256", None),
    "conformer_small": ("mt3_full_plus", None),
}


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def jax_spec(path, shape, n_model=2):
    """JAX shard_params' placement: `_param_spec`, replicated where the
    sharded axis does not divide. → the sharded flax axis, or None."""
    spec = _param_spec(path, len(shape))
    for dim, name in enumerate(spec):
        if name is not None:
            return None if shape[dim] % n_model else dim
    return None


def port_name(path):
    for pat, tmpl, tf in INVERSE_RULES:
        m = re.fullmatch(pat, path)
        if m:
            return tmpl.format(*m.groups()), tf
    raise KeyError(path)


@pytest.mark.parametrize("preset", list(FULL_WIDTH))
def test_placement_equals_jax_param_spec(preset):
    task, counts = FULL_WIDTH[preset]
    tm = TaskManager(task)
    fields = dict(vocab_size=tm.vocab_size, num_channels=tm.num_decoding_channels,
                  max_target_length=tm.max_token_length)
    jcfg = jax_model_config(preset).replace(**fields)
    ac = JaxAudioConfig()
    shapes = jax.eval_shape(JaxYMT3(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, ac.num_frames, ac.num_feature_bins)),
                            jnp.zeros((1, jcfg.num_channels, 8), jnp.int32))
    flat = flatten_params(jax.tree_util.tree_map(lambda s: np.empty(s.shape, np.int8),
                                                 shapes))
    with torch.device("meta"):
        model = YMT3(get_model_config(preset).replace(**fields), ac.num_feature_bins)
    ported = dict(model.named_parameters())
    assert len(ported) == len(flat)
    tally = [0, 0, 0, 0]
    for path, arr in flat.items():
        name, tf = port_name(path)
        want = jax_spec(path, arr.shape)
        if want is not None and tf == "t":
            want = 1 - want
        spec = param_spec(name, ported[name], 2)
        got = spec.dim if hasattr(spec, "dim") else None
        assert got == want, (path, name, got, want)
        if want is None:
            tally[2] += 1
        elif arr.ndim == 3:
            tally[3] += 1
        else:
            tally[1 if path.endswith(("/o/kernel", "/wo/kernel", "/pointwise_out/kernel"))
                  else 0] += 1
    print(preset, "column, row, replicated, expert:", tally)
    if counts is not None:
        assert tuple(tally) == counts


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def jax_bundle(preset, task, overrides):
    """JAX's fp32 bundle without dropout at the small audio config."""
    ac = JaxAudioConfig(**SMALL)
    tm = JaxTaskManager(task, ac)
    cfg = jax_model_config(preset).replace(
        vocab_size=tm.vocab_size, num_channels=tm.num_decoding_channels,
        max_target_length=tm.max_token_length, **FP32, **overrides)
    model = JaxYMT3(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, ac.num_frames, ac.num_feature_bins)),
                                 jnp.zeros((1, cfg.num_channels, 8), jnp.int32))
    return JaxModelBundle(model, params, JaxFrontend.from_config(ac), tm, ac)


def global_batches(tm, n, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(SMALL["input_frames"]) / 16000
    out = []
    for _ in range(n):
        audio = (0.3 * np.sin(2 * np.pi * rng.uniform(200, 800, (4, 1)) * t)
                 + 0.05 * rng.standard_normal((4, SMALL["input_frames"])))
        labels = rng.integers(3, tm.vocab_size, (4, tm.num_decoding_channels,
                                                 tm.max_token_length))
        for row, keep in enumerate(NON_PAD):
            labels[row, :, keep:] = 0
        out.append({"audio": audio.astype(np.float32),
                    "labels": labels.astype(np.int32)})
    return out


def jax_tp_steps(jb, params, opt, lr, batches, n_data, n_model):
    """JAX's train step with the state placed by its shard_params on a
    (n_data, n_model) mesh: → (metrics by step, weights after each step,
    bridged)."""
    tx = jax_make_optimizer(opt, lr, "constant", 1, len(batches))
    step = jax_make_step(jb.model, jb.frontend, tx)
    m = jax_make_mesh(n_data=n_data, n_model=n_model)
    metrics, weights = [], []
    with m:
        state = jax_shard_params(m, jax_create_state(
            jax.tree_util.tree_map(jnp.asarray, params), tx))
        for i, b in enumerate(batches):
            state, out = step(state, jax_shard_batch(m, b), jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in out.items()})
            weights.append(state_dict_from_jax(numpy_params(state.params)))
    return metrics, weights


def _in_thread(fn, *args):
    err = []

    def run():
        try:
            fn(*args)
        except BaseException as e:  # re-raised by join
            err.append(e)
    t = threading.Thread(target=run, daemon=True)
    t.start()

    def join():
        t.join()
        if err:
            raise err[0]
    return join


def rel(a, b):
    return ((a - b).norm() / b.norm()).item()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case: the ranks of (1, 2) and of (2, 2) train in spawned
    groups while this process runs JAX's sharded steps and the port's
    one-process steps."""
    tmp = tmp_path_factory.mktemp("tp")
    jbs = {model: jax_bundle(*MODELS[model]) for model in JAX_MODELS}
    specs = {}
    for name, (model, opt, lr, dropout, aug, layouts, vs_jax, fp32_proj) in CASES.items():
        preset, task, overrides = MODELS[model]
        if model in jbs:
            batches = global_batches(jbs[model].task_manager, STEPS)
            state_dict = state_dict_from_jax(numpy_params(jbs[model].params))
        else:
            batches = global_batches(TaskManager(task, AudioConfig(**SMALL)), STEPS)
            state_dict = None
        specs[name] = dict(preset=preset, task=task,
                           overrides=dict(overrides, dropout_rate=dropout),
                           state_dict=state_dict, batches=batches, optimizer=opt, lr=lr,
                           spec_augment=aug, fp32_projection=fp32_proj)
        torch.save(specs[name], tmp / f"{name}.pt")
    joins = [_in_thread(run_ranks, tp_job, 2, tmp, 2, list(CASES)),
             _in_thread(run_ranks, tp_job, 4, tmp, 2,
                        [n for n, c in CASES.items() if (2, 2) in c[5]])]
    try:
        one = {}
        for name, spec in specs.items():
            one[name] = tp_steps(tp_bundle(spec), spec)
        jax_runs = {}
        for name, (model, opt, lr, dropout, aug, layouts, vs_jax, _) in CASES.items():
            if vs_jax:
                params = numpy_params(jbs[model].params)
                for layout in layouts:
                    jax_runs[name, layout] = jax_tp_steps(
                        jbs[model], params, opt, lr, specs[name]["batches"], *layout)
    finally:
        for join in joins:
            join()
    tp = {(name, layout): torch.load(tmp / f"{name}_tp{layout[0]}x{layout[1]}.pt")
          for name, c in CASES.items() for layout in c[5]}
    return dict(tmp=tmp, one=one, jax=jax_runs, tp=tp)


def sensitive_tensors(runs, name):
    """The tensors upstream of a Perceiver-TF's bf16 group projection: the
    gradient of the memory reaches them rounded to bf16, and the sharded
    step sums the decoder's partial gradients of the memory in another
    order than one process or GSPMD does, so their gradients agree to
    bf16's rounding. With that projection in fp32 (the cases that say so)
    every tensor is held to TOL_WEIGHT_REL."""
    model, fp32_proj = CASES[name][0], CASES[name][7]
    if fp32_proj or not MODELS[model][0].startswith("perceiver"):
        return set()
    return {k for k in runs["one"][name][1][0]
            if k.startswith(("encoder.", "projection."))}


def check_weights(runs, name, got, want, what):
    """Each tensor by its relative error: TOL_WEIGHT_REL, or
    TOL_ORDER_SENSITIVE over the order-sensitive tensors' elements outside
    the rounding band of the one-process step's first gradient, with at
    most BAND_MAX of the case's elements in the band
    (torch_parallel_util.check_weights)."""
    util_check_weights(got, want, runs["one"][name][2][0], sensitive_tensors(runs, name),
                       what, TOL_WEIGHT_REL, TOL_ORDER_SENSITIVE, BAND_MAX)


LAYOUT_CASES = [(name, layout) for name, c in CASES.items() for layout in c[5]]


@pytest.mark.parametrize("name,layout", LAYOUT_CASES)
def test_tp_step_matches_the_one_process_step(runs, name, layout):
    """The sharded step computes what one process computes: losses,
    gradient norms and weights after one and two steps (with dropout and
    SpecAugment on, from the same masks)."""
    got, want = runs["tp"][name, layout], runs["one"][name]
    tol = TOL_ORDER_SENSITIVE if sensitive_tensors(runs, name) else TOL_WEIGHT_REL
    assert len(got["metrics"]) == len(want[0]) == STEPS
    for i, (g, w) in enumerate(zip(got["metrics"], want[0])):
        assert abs(g["loss"] - w["loss"]) <= TOL_LOSS_REL * abs(w["loss"]), (g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) <= tol * w["grad_norm"], (g, w)
        check_weights(runs, name, got["weights"][i], want[1][i],
                      f"{name} {layout} step {i + 1}")


@pytest.mark.parametrize("name,layout", [(n, lay) for n, lay in LAYOUT_CASES
                                         if CASES[n][6]])
def test_tp_step_matches_jax_at_the_same_layout(runs, name, layout):
    """The losses and weights after one and two steps are those of JAX's
    step on a mesh of the same layout."""
    got, (jm, jw) = runs["tp"][name, layout], runs["jax"][name, layout]
    assert len(got["metrics"]) == len(jm) == STEPS
    for i, (g, w) in enumerate(zip(got["metrics"], jm)):
        assert abs(g["loss"] - w["loss"]) <= TOL_LOSS_REL * abs(w["loss"]), (g, w)
        assert sorted(got["weights"][i]) == sorted(jw[i])
        check_weights(runs, name, got["weights"][i], jw[i],
                      f"vs JAX {name} {layout} step {i + 1}")


@pytest.mark.parametrize("layout", [(1, 2), (2, 2)])
def test_sharded_checkpoint_restores_in_one_process(runs, layout):
    """save_bundle of the sharded model (every rank gathers, rank 0
    writes) restores in one process with the gathered weights."""
    d = runs["tmp"] / f"t5_tiny_tp{layout[0]}x{layout[1]}"
    bundle = load_checkpoint(str(d), device="cpu")
    want = runs["tp"]["t5_tiny", layout]["weights"][-1]
    for k, v in bundle.model.state_dict().items():
        assert not hasattr(v, "placements") and torch.equal(v, want[k]), k


def test_graft_entry_dryrun_over_four_ranks(capfd):
    """The dry run prints both of the reference's layouts for both models."""
    from yourmt3_tpu_torch.graft_entry import dryrun_multichip
    dryrun_multichip(4, timeout_s=300.0)
    out = capfd.readouterr().out
    for preset in ("t5_tiny", "perceiver_tf_mc13_moe"):
        for layout in ("data=4, model=1", "data=2, model=2"):
            assert f"{preset} mesh=({layout}) ok: loss=" in out, out
    assert "chunk_parallel data=4 ok" in out
