"""The port's data-parallel training and chunk-parallel evaluation at
world 2 (gloo ranks on the CPU, tests/torch_parallel_util.py) against the
JAX package's sharded train step and chunk stream on its virtual 8-device
mesh, and against the port's own single-process path.

Training parity runs in fp32 with dropout and SpecAugment off, from
weights bridged with `state_dict_from_jax`; the two halves of each global
batch hold different numbers of non-pad tokens, so a per-rank token mean
averaged over the ranks would differ from the global mean that both
packages must compute."""

import dataclasses
import json
import pickle
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
from yourmt3_tpu.parallel.chunk_stream import \
    transcribe_song_chunk_parallel as jax_chunk_parallel
from yourmt3_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from yourmt3_tpu.train.optim import make_optimizer as jax_make_optimizer
from yourmt3_tpu.train.train_step import create_train_state as jax_create_state
from yourmt3_tpu.train.train_step import make_train_step as jax_make_step
from yourmt3_tpu.tokens.task_manager import TaskManager as JaxTaskManager
from yourmt3_tpu_torch.data.dataset_eval import AudioFileDataset
from yourmt3_tpu_torch.data.preprocess.synth import build_synth_dataset
from yourmt3_tpu_torch.eval.evaluator import evaluate_file_dataset
from yourmt3_tpu_torch.parallel import mesh
from yourmt3_tpu_torch.parallel.chunk_stream import transcribe_song_chunk_parallel
from yourmt3_tpu_torch.train.trainer import train
from yourmt3_tpu_torch.weights import state_dict_from_jax

from torch_parallel_util import (FP32, SMALL, module_job, notes_key, port_bundle,
                                 run_ranks)
from torch_port_util import numpy_params, one_intra_op_thread  # noqa: F401

WORLD = 2
# the tiny MoE flagship of the JAX package's multi-chip dry run
MOE_FLAGSHIP = ("perceiver_tf_mc13_moe", "mc13_full_plus_256", dict(
    d_model=64, d_kv=16, num_heads=4, d_ff=128, num_decoder_layers=2,
    ptf_num_latents=26, ptf_d_latent=32, ptf_num_blocks=1, ptf_num_moe_experts=4))
T5_TINY = ("t5_tiny", "mt3_full_plus_256", {})
# (model, grad_accum_steps, global batches): the accumulation case stops
# one micro-step into its second window, so the checkpoint holds the
# gradients pending in .grad, folded into the optimizer state
CASES = {"t5_tiny": (T5_TINY, 1, 2), "moe_flagship": (MOE_FLAGSHIP, 1, 2),
         "t5_tiny_accum2": (T5_TINY, 2, 3)}
OPT = dict(optimizer="adamw", base_lr=1e-4, schedule="constant", warmup_steps=1)
# fp32 on both sides, sums in another order (and over two ranks): the
# loss agrees to a few ulps, and the weights are held per tensor by
# ||port - jax|| / ||jax||. The MoE flagship's arithmetic is sensitive to
# that order: its group projection computes in bf16 on both sides, where
# fp32 inputs a few ulps apart round one bf16 ulp apart in places (ROADMAP
# Queue 3), and Adam's second step amplifies the difference where two
# steps' gradients nearly cancel. JAX itself shows it: its own step on a
# mesh of 4 devices leaves about 15 of the 82 tensors more than 1e-5 from
# its mesh of 2, up to 3.7e-4 (the pre-encoder's conv biases); on t5_tiny
# its meshes agree. So the test reads the reference's own spread: a
# tensor that JAX's meshes of 2 and 4 leave more than ORDER_SENSITIVE
# apart is held to TOL_ORDER_SENSITIVE (the port measured up to 3.8e-4
# there), every other tensor of every case to TOL_PARAM_REL (the port
# measured up to 3.1e-6 on the MoE flagship's). The MoE flagship's
# gradient norm, one sum over all those tensors, is held to
# TOL_ORDER_SENSITIVE as in tests/test_torch_train.py (measured up to
# 2.6e-4), t5_tiny's to TOL_PARAM_REL.
TOL_LOSS = 1e-5
TOL_PARAM_REL = 1e-5
ORDER_SENSITIVE = 1e-6
TOL_ORDER_SENSITIVE = 1e-3
# non-pad tokens of the four rows of a global batch: rank 0 holds the
# first two rows, rank 1 the last two
NON_PAD = (200, 150, 40, 25)
# the song of the JAX package's chunk-parallel test, decoded to 32 tokens
CHUNK_SPD, CHUNK_L = 2, 32


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


def jax_bundle(preset, task, overrides):
    """JAX's `api.init_model` at the small audio config in fp32, with its
    model.init jitted: the eager init takes three times as long on the
    CPU."""
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


def jax_sharded_steps(jb, params, accum, batches, m):
    """JAX's train step over the mesh `m` from `params` (numpy: the step
    donates its state's buffers): → (per-step metrics; final weights,
    bridged; MultiSteps' gradient mean, bridged)."""
    tx = jax_make_optimizer(OPT["optimizer"], OPT["base_lr"], OPT["schedule"],
                            OPT["warmup_steps"], len(batches), grad_accum_steps=accum)
    codec = jb.task_manager.codec
    lo = codec.offset_of("shift")
    step = jax_make_step(jb.model, jb.frontend, tx,
                         shift_id_range=(lo, lo + codec.max_shift_steps + 1))
    metrics = []
    with m:
        state = replicate(m, jax_create_state(params, tx))
        for i, b in enumerate(batches):
            state, out = step(state, shard_batch(m, b), jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in out.items()})
    acc = (state_dict_from_jax(numpy_params(state.opt_state.acc_grads))
           if accum > 1 else None)
    return metrics, state_dict_from_jax(numpy_params(state.params)), acc


def _in_thread(fn, *args):
    """Start fn(*args) in a thread; → a join() that re-raises its error."""
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


@pytest.fixture(scope="module")
def module_runs(tmp_path_factory):
    """Every case of this module from one group of ranks: the port's
    DDP training of each case and its chunk-parallel jobs run in the
    spawned ranks while this process runs JAX's references."""
    tmp = tmp_path_factory.mktemp("parallel")
    jbs = {preset: jax_bundle(preset, task, overrides)
           for preset, task, overrides in (T5_TINY, MOE_FLAGSHIP)}
    params = {p: numpy_params(jb.params) for p, jb in jbs.items()}
    sd0 = {p: state_dict_from_jax(v) for p, v in params.items()}
    batches = {}
    for name, ((preset, task, overrides), accum, n) in CASES.items():
        batches[name] = global_batches(jbs[preset].task_manager, n)
        torch.save(dict(preset=preset, task=task, overrides=overrides,
                        state_dict=sd0[preset], batches=batches[name],
                        train_kw=dict(OPT, grad_accum_steps=accum)),
                   tmp / f"{name}.pt")
    rng = np.random.default_rng(0)
    song = (rng.standard_normal(int(16000 * 3.1)) * 0.1).astype(np.float32)
    split = build_synth_dataset(str(tmp), n_tracks=2, duration=2.5, splits=("test",),
                                seed=5, dataset_name="cp")["test"]
    torch.save(dict(preset=T5_TINY[0], task=T5_TINY[1], state_dict=sd0["t5_tiny"],
                    song=song, segments_per_device=CHUNK_SPD, max_length=CHUNK_L,
                    split=split),
               tmp / "chunk.pt")
    join = _in_thread(run_ranks, module_job, WORLD, tmp, list(CASES))
    try:
        m = make_mesh(n_data=WORLD)
        jnotes, jerrs = jax_chunk_parallel(jbs["t5_tiny"], song, m,
                                           segments_per_device=CHUNK_SPD,
                                           max_length=CHUNK_L)
        jax_runs = {name: jax_sharded_steps(jbs[preset], params[preset], accum,
                                            batches[name], m)
                    for name, ((preset, _, _), accum, _) in CASES.items()}
        moe = MOE_FLAGSHIP[0]
        _, weights4, _ = jax_sharded_steps(jbs[moe], params[moe], 1,
                                           batches["moe_flagship"], make_mesh(n_data=4))
    finally:
        join()
    want = jax_runs["moe_flagship"][1]
    spread = {k: ((v - want[k]).norm() / want[k].norm()).item()
              for k, v in weights4.items()}
    sensitive = {k for k, v in spread.items() if v > ORDER_SENSITIVE}
    return dict(tmp=tmp, jax_runs=jax_runs, moe_sensitive=sensitive,
                song=song, split=split,
                chunk_jax=(notes_key(jnotes), dataclasses.asdict(jerrs)),
                t5_weights=sd0["t5_tiny"])


@pytest.fixture(scope="module", params=list(CASES))
def ddp_run(request, module_runs):
    name, tmp = request.param, module_runs["tmp"]
    jm, jparams, jacc = module_runs["jax_runs"][name]
    with open(tmp / name / "train_log.jsonl") as f:
        pm = [json.loads(line) for line in f]
    ranks = [torch.load(tmp / f"{name}_rank{r}.pt") for r in range(WORLD)]
    opt = torch.load(tmp / name / "last" / "opt_state.pt")
    return dict(name=name, accum=CASES[name][1], jm=jm, pm=pm, jparams=jparams,
                jacc=jacc, ranks=ranks, opt=opt,
                sensitive=module_runs["moe_sensitive"] if name == "moe_flagship" else set())


def test_ddp_loss_matches_jax_sharded_step(ddp_run):
    """Every step's loss and accuracy is the global token mean, as JAX's
    step computes it on the sharded global batch."""
    jm, pm = ddp_run["jm"], ddp_run["pm"]
    assert len(pm) == len(jm)
    for j, p in zip(jm, pm):
        assert abs(p["loss"] - j["loss"]) < TOL_LOSS, (p["loss"], j["loss"])
        for k in ("accuracy", "shift_accuracy", "shift_accuracy_50ms"):
            assert abs(p[k] - j[k]) < 1e-6, (k, p[k], j[k])
    if ddp_run["accum"] > 1:  # no grad_norm on the steps under no_sync
        assert ["grad_norm" in p for p in pm] == [False, True, False]
    else:
        tol = TOL_ORDER_SENSITIVE if ddp_run["sensitive"] else TOL_PARAM_REL
        for j, p in zip(jm, pm):
            assert abs(p["grad_norm"] - j["grad_norm"]) <= tol * j["grad_norm"], (
                p["grad_norm"], j["grad_norm"], tol)
    assert all(p["target_tokens_per_sec"] > 0 for p in pm)


def test_ddp_weights_match_jax_sharded_step(ddp_run):
    """The weights after the steps agree with JAX's (loosened only on the
    tensors whose value JAX's own meshes leave apart), and every rank holds
    the same weights."""
    jparams, ranks, sensitive = ddp_run["jparams"], ddp_run["ranks"], ddp_run["sensitive"]
    assert sorted(ranks[0]) == sorted(jparams)
    assert len(sensitive) <= 2 * len(jparams) // 3, sorted(sensitive)
    for k, want in jparams.items():
        err = ((ranks[0][k] - want).norm() / want.norm()).item()
        tol = TOL_ORDER_SENSITIVE if k in sensitive else TOL_PARAM_REL
        assert err <= tol, (k, err, tol)
        for other in ranks[1:]:
            assert torch.equal(other[k], ranks[0][k]), k


def test_ddp_checkpoint_holds_the_pending_micro_gradients(ddp_run):
    """rank 0 wrote the checkpoint; with accumulation cut mid-window the
    optimizer state's gradient mean equals optax.MultiSteps' after the
    same micro-steps."""
    opt = ddp_run["opt"]
    assert opt["step"] == len(ddp_run["pm"])
    if ddp_run["accum"] == 1:
        return
    state = opt["opt_state"]
    assert state["mini_step"] == 1 and state["gradient_step"] == 1
    for k, want in ddp_run["jacc"].items():
        err = (state["acc"][k] - want).abs().max().item()
        assert err <= 1e-5 * max(want.abs().max().item(), 1e-6), (k, err)


def test_n_data_shards_must_match_the_world(tmp_path):
    """One process has world 1: two shards are refused, none or one
    train."""
    b = port_bundle(*T5_TINY)
    batches = global_batches(b.task_manager, 1)
    with pytest.raises(ValueError, match="n_data_shards=2"):
        train(b, iter(batches), total_steps=1, ckpt_every=0,
              ckpt_dir=str(tmp_path), spec_augment=False, n_data_shards=2)
    train(b, iter(batches), total_steps=1, ckpt_every=0, ckpt_dir=str(tmp_path),
          spec_augment=False, n_data_shards=None)
    assert mesh.world_size() == 1 and mesh.shard_batch(batches[0])["audio"].shape[0] == 4


# ---------------------------------------------------------------------------
# chunk-parallel transcription and evaluation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chunk_run(module_runs):
    ranks = []
    for r in range(WORLD):
        with open(module_runs["tmp"] / f"chunk_rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    single = port_bundle(*T5_TINY, module_runs["t5_weights"])
    return dict(ranks=ranks, song=module_runs["song"], split=module_runs["split"],
                single=single, jax=module_runs["chunk_jax"])


def test_chunk_parallel_matches_jax_and_the_single_device_path(chunk_run):
    """World 2 gives JAX's notes and errors, and the port's own
    one-process path gives them too (batches of segments_per_device)."""
    ranks = chunk_run["ranks"]
    jnotes, jerrs = chunk_run["jax"]
    notes, errs = transcribe_song_chunk_parallel(
        chunk_run["single"], chunk_run["song"], segments_per_device=CHUNK_SPD,
        max_length=CHUNK_L)
    assert notes_key(notes) == jnotes and dataclasses.asdict(errs) == jerrs
    for r in ranks:
        assert r["notes"] == jnotes and r["errors"] == jerrs


def test_replicate_broadcasts_rank_0s_weights(chunk_run):
    assert [r["replicated"] for r in chunk_run["ranks"]] == [[[1.0] * 3] * 2] * WORLD


def test_chunk_parallel_empty_song_returns_a_list(chunk_run):
    assert all(isinstance(r["empty"], list) for r in chunk_run["ranks"])


def test_mesh_evaluation_metrics_equal_the_single_device_path(chunk_run):
    """evaluate_file_dataset over the group: every rank's metrics equal
    the one-process path's at batch_size = segments_per_device."""
    b = chunk_run["single"]
    single = evaluate_file_dataset(b, AudioFileDataset(chunk_run["split"], b.audio_cfg),
                                   batch_size=CHUNK_SPD, verbose=False)
    for r in chunk_run["ranks"]:
        assert r["metrics"] == single


@pytest.mark.parametrize("what,match", [("beam", "beam_size"),
                                        ("repetition", "repetition_guard"),
                                        ("repair", "repair_beam"),
                                        ("contiguous", "contiguous")])
def test_mesh_evaluation_refuses_what_the_reference_refuses(chunk_run, what, match):
    for r in chunk_run["ranks"]:
        assert match in r["refused"][what]


# ---------------------------------------------------------------------------
# the dry-run entry
# ---------------------------------------------------------------------------

def test_graft_entry_dryrun_over_two_ranks(capfd):
    """One DDP train step of t5_tiny and of the tiny MoE flagship per rank,
    then the chunk-parallel equivalence check, over two gloo processes."""
    from yourmt3_tpu_torch.graft_entry import dryrun_multichip
    dryrun_multichip(WORLD, timeout_s=300.0)
    out = capfd.readouterr().out
    for what in ("t5_tiny data=2 ok", "perceiver_tf_mc13_moe data=2 ok",
                 "chunk_parallel data=2 ok"):
        assert what in out, out


def test_graft_entry_forward_at_full_width():
    from yourmt3_tpu_torch.graft_entry import entry
    forward, (audio, labels) = entry(device="cpu")
    with torch.no_grad():
        logits = forward(audio, labels)
    assert logits.shape[:-1] == labels.shape and bool(torch.isfinite(logits).all())
