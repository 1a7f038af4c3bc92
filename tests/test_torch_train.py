"""The port's training path against the JAX package: shift_right/ce_loss,
the teacher-forced forward, the optimizers and schedules (against
optax), the train step over a few updates, the pitch shift, SpecAugment
and dropout (by property: the generators differ), one step of the tiny
flagship, and the copied training dataset.

Parity runs in fp32 on the CPU with dropout and SpecAugment off, from
weights bridged with `state_dict_from_jax`, on the small audio config of
the JAX package's own tests."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from yourmt3_tpu.api import init_model as jax_init_model
from yourmt3_tpu.config.audio import AudioConfig as JaxAudioConfig
from yourmt3_tpu.config.model import PERCEIVER_TF_MC13 as JAX_FLAGSHIP
from yourmt3_tpu.data.dataset_train import TrainDataset as JaxTrainDataset
from yourmt3_tpu.data.preprocess.synth import build_synth_dataset as jax_build_synth
from yourmt3_tpu.models.ymt3 import ce_loss as jax_ce_loss
from yourmt3_tpu.models.ymt3 import shift_right as jax_shift_right
from yourmt3_tpu.ops.pitchshift import pitch_shift_fixed as jax_pitch_shift
from yourmt3_tpu.train.optim import make_optimizer as jax_make_optimizer
from yourmt3_tpu.train.optim import make_schedule as jax_make_schedule
from yourmt3_tpu.train.train_step import create_train_state as jax_create_state
from yourmt3_tpu.train.train_step import make_train_step as jax_make_step
from yourmt3_tpu_torch.api import init_model
from yourmt3_tpu_torch.config.audio import AudioConfig
from yourmt3_tpu_torch.config.model import PERCEIVER_TF_MC13
from yourmt3_tpu_torch.data.dataset_train import TrainDataset
from yourmt3_tpu_torch.data.preprocess.synth import build_synth_dataset
from yourmt3_tpu_torch.models.layers import Dropout
from yourmt3_tpu_torch.models.ymt3 import ce_loss, shift_right
from yourmt3_tpu_torch.ops import specaugment as sa
from yourmt3_tpu_torch.ops.pitchshift import pitch_shift_fixed
from yourmt3_tpu_torch.train import optim
from yourmt3_tpu_torch.train.train_step import create_train_state, make_train_step
from yourmt3_tpu_torch.weights import state_dict_from_jax

from torch_port_util import numpy_params

SMALL = dict(input_frames=4095, n_fft=512, hop_length=128, n_mels=64)
TASK = "mt3_full_plus_256"
TINY_FLAGSHIP = dict(d_model=64, d_kv=16, num_heads=4, d_ff=128,
                     num_decoder_layers=2, ptf_d_latent=64, ptf_num_blocks=1,
                     conv_channels=8)
# fp32 on both sides, sums in another order: the loss and the gradient
# norm agree to a few fp32 ulps per step. Adam divides each gradient by
# its own RMS, so an element whose gradient is at the level of the
# rounding differences (a few attention K/Q weights) can move by a few
# percent of lr apart; at lr 1e-4 that stays under TOL_PARAM.
TOL_REL, TOL_PARAM = 1e-5, 1e-5
NO_DROPOUT = dict(compute_dtype="float32", dropout_rate=0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny: one intra-op thread runs them about as
    fast, and leaves the other cores to the test files running beside
    this one under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def bridged(preset="t5_tiny", task=TASK, audio=SMALL, **overrides):
    """(JAX bundle, port bundle) with identical fp32 weights on the CPU."""
    jb = jax_init_model(preset, task, audio_cfg=JaxAudioConfig(**audio),
                        **NO_DROPOUT, **overrides)
    pb = init_model(preset, task, audio_cfg=AudioConfig(**audio), device="cpu",
                    **NO_DROPOUT, **overrides)
    pb.model.load_state_dict(state_dict_from_jax(numpy_params(jb.params)),
                             strict=True)
    return jb, pb


def make_batch(tm, audio_cfg, batch=2, seed=0, pad_from=200):
    rng = np.random.default_rng(seed)
    t = np.arange(audio_cfg.input_frames) / audio_cfg.sample_rate
    audio = (0.3 * np.sin(2 * np.pi * rng.uniform(200, 800, (batch, 1)) * t)
             + 0.05 * rng.standard_normal((batch, audio_cfg.input_frames)))
    labels = rng.integers(3, tm.vocab_size, (batch, tm.num_decoding_channels,
                                             tm.max_token_length))
    labels[..., pad_from:] = 0  # PAD tail: masked out of the loss
    return {"audio": audio.astype(np.float32), "labels": labels.astype(np.int32)}


def shift_range(tm):
    lo = tm.codec.offset_of("shift")
    return lo, lo + tm.codec.max_shift_steps + 1


@pytest.fixture(scope="module")
def tiny():
    return bridged()


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_shift_right_and_ce_loss_match_jax(smoothing):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 3, 16, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (2, 3, 16)).astype(np.int32)
    labels[:, :, 12:] = 0
    assert np.array_equal(shift_right(torch.from_numpy(labels)).numpy(),
                          np.asarray(jax_shift_right(jnp.asarray(labels))))
    want = jax_ce_loss(jnp.asarray(logits), jnp.asarray(labels), smoothing)
    got = ce_loss(torch.from_numpy(logits), torch.from_numpy(labels), smoothing)
    for g, w in zip(got, want):
        assert abs(float(g) - float(w)) <= 1e-6 * max(1.0, abs(float(w)))


def test_teacher_forced_logits_match_jax(tiny):
    jb, pb = tiny
    batch = make_batch(pb.task_manager, pb.audio_cfg)
    ids = jax_shift_right(jnp.asarray(batch["labels"]))
    want = jb.model.apply(jb.params, jb.frontend(jnp.asarray(batch["audio"])), ids)
    with torch.no_grad():
        got = pb.model(pb.frontend(torch.from_numpy(batch["audio"])),
                       torch.from_numpy(np.asarray(ids)).long())
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-4


def _run_steps(jb, pb, batches, opt_kw, steps=3):
    """Run `steps` train steps on both sides; → (jax metrics, port
    metrics, jax params as a port state dict)."""
    tm = pb.task_manager
    jtx = jax_make_optimizer(**opt_kw)
    jstep = jax_make_step(jb.model, jb.frontend, jtx, shift_id_range=shift_range(tm))
    jstate = jax_create_state(jb.params, jtx)
    ptx = optim.make_optimizer(**opt_kw)
    pstep = make_train_step(pb.model, pb.frontend, ptx, shift_id_range=shift_range(tm))
    pstate = create_train_state(pb.model, ptx)
    jm, pm = [], []
    for i in range(steps):
        b = batches[i % len(batches)]
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                          jax.random.PRNGKey(i))
        jm.append({k: float(v) for k, v in m.items()})
        pstate, m = pstep(pstate, b, None)
        pm.append({k: float(v) for k, v in m.items()})
    assert pstate.step == steps
    return jm, pm, state_dict_from_jax(numpy_params(jstate.params))


OPTIMIZERS = {
    "adamw": dict(name="adamw", base_lr=1e-4, schedule="cosine",
                  warmup_steps=1, total_steps=3, grad_clip=1.0),
    "adafactor": dict(name="adafactor", base_lr=1e-2, schedule="constant",
                      warmup_steps=1, total_steps=3, grad_clip=1.0),
    "accum2": dict(name="adamw", base_lr=1e-4, schedule="constant",
                   warmup_steps=1, total_steps=4, grad_clip=1.0,
                   grad_accum_steps=2),
}


@pytest.mark.parametrize("kind", list(OPTIMIZERS))
def test_train_steps_match_jax(kind):
    """The same bridged weights and batches through JAX's make_train_step
    and the port's: every step's metrics and the final weights agree. The
    accumulation case alternates two batches over 4 micro-steps (2
    updates)."""
    jb, pb = bridged()
    tm = pb.task_manager
    batches = [make_batch(tm, pb.audio_cfg, seed=s) for s in (0, 1)]
    steps = 4 if kind == "accum2" else 3
    jm, pm, jparams = _run_steps(jb, pb, batches if kind == "accum2" else batches[:1],
                                 OPTIMIZERS[kind], steps)
    for j, p in zip(jm, pm):
        assert set(p) == set(j)
        for k in ("loss", "grad_norm", "grad_norm_postclip"):
            assert abs(p[k] - j[k]) <= TOL_REL * abs(j[k]), (k, p[k], j[k])
        for k in ("accuracy", "shift_accuracy", "shift_accuracy_50ms"):
            assert abs(p[k] - j[k]) < 1e-6, (k, p[k], j[k])
    assert pm[0]["grad_norm"] > 1.0  # clipping was active
    assert pm[-1]["loss"] != pm[0]["loss"]  # the weights moved
    sd = pb.model.state_dict()
    assert sorted(sd) == sorted(jparams)
    err = max((sd[k] - jparams[k]).abs().max().item() for k in sd)
    assert err < TOL_PARAM, err


def test_optimizer_updates_match_optax_on_transposed_layouts():
    """AdaFactor's factored statistics (axes of 128 and more), AdamW with
    weight decay and clipping, against optax on random trees; the port
    holds (out, in[, kh, kw]) weights, optax the reference's (in, out) and
    (kh, kw, in, out) kernels."""
    rng = np.random.default_rng(0)
    shapes = {"dense": (256, 128), "conv": (128, 128, 3, 3), "vec": (64,),
              "small": (32, 64)}
    to_jax = {"dense": lambda a: a.T, "conv": lambda a: a.transpose(2, 3, 1, 0),
              "vec": lambda a: a, "small": lambda a: a.T}
    params = {k: rng.standard_normal(s).astype(np.float32) * 0.1
              for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 4, 1e-3)
    for name, jtx, ptx in [
        ("adafactor", optax.adafactor(sched),
         optim.adafactor(optim.make_schedule("cosine", 1e-2, 1, 4))),
        ("adamw", optax.chain(optax.clip_by_global_norm(1.0),
                              optax.adamw(sched, weight_decay=0.1)),
         optim.chain(optim.clip_by_global_norm(1.0),
                     optim.adamw(optim.make_schedule("cosine", 1e-2, 1, 4),
                                 weight_decay=0.1))),
    ]:
        jp = {k: jnp.asarray(to_jax[k](v)) for k, v in params.items()}
        pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        js, ps = jtx.init(jp), ptx.init(pp)
        for g in grads:
            ju, js = jtx.update({k: jnp.asarray(to_jax[k](v)) for k, v in g.items()},
                                js, jp)
            jp = optax.apply_updates(jp, ju)
            pu, ps = ptx.update({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp)
            pp = {k: pp[k] + pu[k] for k in pp}
        for k in params:
            err = np.abs(to_jax[k](pp[k].numpy()) - np.asarray(jp[k])).max()
            assert err < 1e-6, (name, k, err)


@pytest.mark.parametrize("name", ["cosine", "legacy", "constant"])
def test_schedules_match_optax(name):
    warmup, total = 10, 100
    want = jax_make_schedule(name, 3e-4, warmup, total)
    got = optim.make_schedule(name, 3e-4, warmup, total)
    for step in (0, 1, warmup, warmup + 1, total):
        w = float(want(jnp.asarray(step, jnp.int32)))
        assert abs(got(step) - w) <= 1e-6 * 3e-4, (step, got(step), w)
    if name == "cosine":
        assert got(0) == 0.0  # the first update has learning rate 0


def test_dadapt_adam_raises_naming_roadmap():
    """D-Adaptation is ported (tests/test_torch_dadapt.py holds it against
    optax): it builds; an optimizer the reference does not have raises."""
    tx = optim.make_optimizer("dadapt_adam")
    assert "estim_lr" in tx.init({"w": torch.zeros(3)})["1"]
    with pytest.raises(ValueError, match="unknown optimizer"):
        optim.make_optimizer("dadapt_sgd")


@pytest.mark.parametrize("semitones", [-2, 1])
def test_pitch_shift_matches_jax(semitones):
    rng = np.random.default_rng(semitones + 5)
    t = np.arange(8000) / 16000
    audio = (0.3 * np.sin(2 * np.pi * 440 * t)[None]
             + 0.02 * rng.standard_normal((2, 8000))).astype(np.float32)
    want = np.asarray(jax_pitch_shift(jnp.asarray(audio), semitones))
    got = pitch_shift_fixed(torch.from_numpy(audio), semitones).numpy()
    assert got.shape == audio.shape
    assert np.abs(got - want).max() < 1e-4


def _runs(mask_1d):
    m = np.concatenate([[False], mask_1d, [False]]).astype(np.int8)
    return np.flatnonzero(np.diff(m) == 1), np.flatnonzero(np.diff(m) == -1)


@pytest.mark.parametrize("fill", ["mean", "zero", "min"])
def test_spec_augment_masks_by_property(fill):
    cfg = sa.SpecAugmentConfig(mask_value=fill)
    feats = torch.randn(16, 256, 128, generator=torch.Generator().manual_seed(0))
    out = sa.spec_augment(torch.Generator().manual_seed(1), feats, cfg)
    gen = torch.Generator().manual_seed(1)  # the same draws, mask by mask
    tmask = sa._axis_mask(gen, 256, cfg.time_mask_width, 16, cfg.num_time_masks, "cpu")
    fmask = sa._axis_mask(gen, 128, cfg.freq_mask_width, 16, cfg.num_freq_masks, "cpu")
    widths = []
    for b in range(16):
        x, y = feats[b].numpy(), out[b].numpy()
        want_fill = {"mean": x.mean(), "zero": 0.0, "min": x.min()}[fill]
        mask = tmask[b][:, None].numpy() | fmask[b][None, :].numpy()
        assert np.array_equal(y[~mask], x[~mask])
        assert np.allclose(y[mask], want_fill, atol=1e-6)
        for m, n, w in ((tmask[b].numpy(), cfg.num_time_masks, cfg.time_mask_width),
                        (fmask[b].numpy(), cfg.num_freq_masks, cfg.freq_mask_width)):
            starts, ends = _runs(m)
            assert len(starts) <= n and (ends - starts <= n * w).all()
            assert m.sum() <= n * w
        widths.append(tmask[b].sum().item())
    assert 0 < np.mean(widths) < 2 * cfg.time_mask_width  # masks were drawn


def test_dropout_keep_rate_scaling_and_eval_identity():
    drop = Dropout(0.25)
    drop.generator = torch.Generator().manual_seed(0)
    x = torch.ones(200_000)
    y = drop.train()(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert torch.equal(drop.eval()(x), x)
    # a model with dropout: eval() is exact, train() draws from its generator
    _, pb = bridged()
    model = pb.model
    ref = init_model("t5_tiny", TASK, audio_cfg=pb.audio_cfg, device="cpu",
                     compute_dtype="float32", dropout_rate=0.1)
    ref.model.load_state_dict(model.state_dict())
    batch = make_batch(pb.task_manager, pb.audio_cfg)
    feats = pb.frontend(torch.from_numpy(batch["audio"]))
    ids = shift_right(torch.from_numpy(batch["labels"])).long()
    with torch.no_grad():
        base = model.eval()(feats, ids)
        assert torch.equal(ref.model.eval()(feats, ids), base)
        ref.model.train()
        outs = []
        for _ in range(2):
            ref.model.set_dropout_generator(torch.Generator().manual_seed(3))
            outs.append(ref.model(feats, ids))
        assert torch.equal(outs[0], outs[1])
        assert not torch.equal(outs[0], base)


def test_tiny_flagship_train_step_matches_jax():
    """One AdamW step of the tiny perceiver_tf_mc13 (fp32, 13 channels,
    the small audio config): the loss within 1e-4. The gradient norm
    passes through the bf16 group projection on both sides, where one-ulp
    rounding differences (ROADMAP Queue 3) move it by ~1e-4 relative."""
    jcfg = JAX_FLAGSHIP.replace(**TINY_FLAGSHIP)
    jb = jax_init_model(model_cfg=jcfg, task="mc13_full_plus_256",
                        audio_cfg=JaxAudioConfig(**SMALL), **NO_DROPOUT)
    pb = init_model(model_cfg=PERCEIVER_TF_MC13.replace(**TINY_FLAGSHIP),
                    task="mc13_full_plus_256", audio_cfg=AudioConfig(**SMALL),
                    device="cpu", **NO_DROPOUT)
    pb.model.load_state_dict(state_dict_from_jax(numpy_params(jb.params)),
                             strict=True)
    batch = make_batch(pb.task_manager, pb.audio_cfg, batch=1, pad_from=40)
    kw = dict(name="adamw", base_lr=1e-3, schedule="constant", grad_clip=1.0)
    jm, pm, _ = _run_steps(jb, pb, [batch], kw, steps=1)
    assert np.isfinite(pm[0]["loss"])
    assert abs(pm[0]["loss"] - jm[0]["loss"]) < 1e-4
    assert abs(pm[0]["grad_norm"] - jm[0]["grad_norm"]) <= 1e-3 * jm[0]["grad_norm"]


def test_train_dataset_batches_match_jax(tmp_path):
    """The copied synth builder writes the same corpus, and the copied
    TrainDataset draws the same batches from it for the same seed."""
    kw = dict(n_tracks=2, duration=3.0, splits=("train",), seed=7)
    jidx = jax_build_synth(str(tmp_path / "jax"), **kw)["train"]
    pidx = build_synth_dataset(str(tmp_path / "port"), **kw)["train"]
    from yourmt3_tpu.tokens.task_manager import TaskManager as JaxTaskManager
    from yourmt3_tpu_torch.tokens.task_manager import TaskManager
    jds = JaxTrainDataset([jidx], JaxTaskManager(TASK), seed=3)
    pds = TrainDataset([pidx], TaskManager(TASK), seed=3)
    for _ in range(2):
        jbatch, pbatch = jds.make_batch(2), pds.make_batch(2)
        assert set(jbatch) == set(pbatch)
        for k in jbatch:
            assert np.array_equal(jbatch[k], pbatch[k]), k
    assert (pbatch["labels"] > 0).sum() > 0
