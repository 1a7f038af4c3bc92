"""The port's checkpoints and training loop on the CPU: save → restore
gives the same weights, optimizer state and step; resume continues the
schedule (and lands where an uninterrupted run does); preemption writes
the last completed step; a checkpoint restores with decode overrides and
serves through the CLI. These mirror tests/test_trainer_resume.py."""

import json
import os

import numpy as np
import pytest
import torch

from yourmt3_tpu_torch.api import init_model, load_checkpoint
from yourmt3_tpu_torch.config.audio import AudioConfig
from yourmt3_tpu_torch.ops.weight_quant import quantize_int8
from yourmt3_tpu_torch.train.checkpoint import restore_opt_state, save_bundle
from yourmt3_tpu_torch.train.trainer import train
from yourmt3_tpu_torch.utils.preemption import PreemptionGuard

TINY_AUDIO = AudioConfig(input_frames=4095, n_fft=512, hop_length=128, n_mels=64)
TASK = "mt3_full_plus_256"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The models here are tiny: one intra-op thread runs them about as
    fast, and leaves the other cores to the test files running beside
    this one under pytest-xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def const_batches(tm, batch_size=2):
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((batch_size, TINY_AUDIO.input_frames)).astype(np.float32) * 0.1
    labels = rng.integers(3, tm.vocab_size, (batch_size, tm.num_decoding_channels,
                                             tm.max_token_length)).astype(np.int32)
    while True:
        yield {"audio": audio, "labels": labels}


def tiny_bundle(**kw):
    return init_model("t5_tiny", TASK, audio_cfg=TINY_AUDIO, device="cpu", **kw)


class Probe:
    def __init__(self, on_log=None):
        self.steps, self.losses = [], []
        self.on_log = on_log

    def log(self, step, metrics, prefix=""):
        self.steps.append(step)
        self.losses.append(metrics["loss"])
        if self.on_log:
            self.on_log(step)

    def close(self):
        pass


def _flat(tree):
    if isinstance(tree, dict):
        return {f"{k}/{kk}": vv for k, v in tree.items() for kk, vv in _flat(v).items()}
    return {"": tree}


def test_save_restore_roundtrip_keeps_weights_opt_state_and_step(tmp_path):
    bundle = tiny_bundle(d_model=48, d_kv=12, num_heads=2, d_ff=96)
    d = str(tmp_path / "ck")
    train(bundle, const_batches(bundle.task_manager), total_steps=2, log_every=1,
          ckpt_every=2, ckpt_dir=d, spec_augment=False, warmup_steps=1,
          logger=Probe())
    last = os.path.join(d, "last")
    with open(os.path.join(last, "ymt3_meta.json")) as f:
        meta = json.load(f)
    assert meta["step"] == 2 and meta["model"]["d_model"] == 48
    assert meta["audio"]["n_mels"] == 64 and meta["task"] == TASK
    b2 = load_checkpoint(last, device="cpu")
    assert b2.cfg.d_model == 48 and b2.audio_cfg == TINY_AUDIO
    sd0, sd1 = bundle.model.state_dict(), b2.model.state_dict()
    assert sorted(sd0) == sorted(sd1)
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)
    saved = restore_opt_state(last)
    assert saved["step"] == 2
    flat = _flat(saved["opt_state"])
    assert flat and any(isinstance(v, torch.Tensor) and v.abs().sum() > 0
                        for v in flat.values())
    # the same state written again reads back identically
    save_bundle(str(tmp_path / "again"), b2, 2, opt_state=saved["opt_state"])
    again = restore_opt_state(str(tmp_path / "again"))
    fa = _flat(again["opt_state"])
    assert fa.keys() == flat.keys()
    assert all(torch.equal(fa[k], flat[k]) if isinstance(flat[k], torch.Tensor)
               else fa[k] == flat[k] for k in flat)


def test_resume_continues_the_schedule(tmp_path):
    """A run preempted after step 3 and resumed restores the optimizer
    state and step: it continues at step 4 and ends with the weights of
    an uninterrupted 5-step run."""
    kw = dict(total_steps=5, log_every=1, ckpt_every=0, spec_augment=False,
              warmup_steps=2, base_lr=1e-3)
    ref = tiny_bundle(dropout_rate=0.0)  # a resumed generator restarts
    train(ref, const_batches(ref.task_manager), ckpt_dir=str(tmp_path / "ref"),
          logger=Probe(), **kw)
    bundle = tiny_bundle(dropout_rate=0.0)
    d = str(tmp_path / "ck")
    first = Probe(on_log=lambda step: step == 3 and PreemptionGuard.instance().request())
    try:
        train(bundle, const_batches(bundle.task_manager), ckpt_dir=d,
              logger=first, **kw)
    finally:
        PreemptionGuard.instance().reset()
    assert first.steps == [1, 2, 3]
    last = os.path.join(d, "last")
    b2 = load_checkpoint(last, device="cpu")
    probe = Probe()
    train(b2, const_batches(b2.task_manager), ckpt_dir=d, logger=probe,
          resume_from=last, **kw)
    assert probe.steps == [4, 5]
    sd_ref, sd = ref.model.state_dict(), b2.model.state_dict()
    err = max((sd_ref[k] - sd[k]).abs().max().item() for k in sd)
    assert err < 1e-6, err


def test_resume_without_opt_state_refuses(tmp_path):
    bundle = tiny_bundle()
    d = str(tmp_path / "w")
    save_bundle(d, bundle, step=7)
    with pytest.raises(ValueError, match="optimizer"):
        train(bundle, const_batches(bundle.task_manager), total_steps=9,
              ckpt_dir=str(tmp_path / "x"), logger=Probe(), resume_from=d)


def test_preemption_writes_the_last_completed_step(tmp_path):
    bundle = tiny_bundle()
    d = str(tmp_path / "ck")
    probe = Probe(on_log=lambda step: step >= 2 and PreemptionGuard.instance().request())
    try:
        train(bundle, const_batches(bundle.task_manager), total_steps=50,
              log_every=1, ckpt_every=0, ckpt_dir=d, spec_augment=False,
              warmup_steps=1, logger=probe)
    finally:
        PreemptionGuard.instance().reset()
    assert probe.steps == [1, 2]
    last = os.path.join(d, "last")
    assert restore_opt_state(last)["step"] == 2
    b2 = load_checkpoint(last, device="cpu")
    sd0, sd1 = bundle.model.state_dict(), b2.model.state_dict()
    assert all(torch.equal(sd0[k], sd1[k]) for k in sd0)


def test_restore_with_decode_overrides_rebuilds_side_cars(tmp_path):
    """Trained masters come back with int8 decoder side-cars made from
    them, and the CLI serves the checkpoint."""
    from yourmt3_tpu_torch.cli import transcribe as cli
    from yourmt3_tpu_torch.data.audio_io import write_wav
    bundle = tiny_bundle()
    d = str(tmp_path / "ck")
    train(bundle, const_batches(bundle.task_manager), total_steps=2, log_every=1,
          ckpt_every=2, ckpt_dir=d, spec_augment=False, warmup_steps=1,
          logger=Probe())
    last = os.path.join(d, "last")
    b2 = load_checkpoint(last, device="cpu", kv_quant="int8", weight_quant="int8")
    assert b2.cfg.kv_quant == "int8" and b2.cfg.weight_quant == "int8"
    head = b2.model.lm_head
    q, scale = quantize_int8(bundle.model.lm_head.weight)
    assert torch.equal(head.weight, bundle.model.lm_head.weight)
    assert torch.equal(head.weight_q, q) and torch.equal(head.weight_scale, scale)
    wav = str(tmp_path / "song.wav")
    write_wav(wav, (0.1 * np.sin(np.arange(8000) / 16000 * 2 * np.pi * 440)
                    ).astype(np.float32), 16000)
    outs = cli.main([wav, "-ckpt", last, "-o", str(tmp_path / "out"), "--cpu",
                     "--decode-path", "fast", "--repair-beam", "0", "-b", "1"])
    assert len(outs) == 1 and os.path.exists(outs[0])


def test_cli_train_on_the_cpu(tmp_path, monkeypatch):
    """`cli.train --cpu` on a freshly built synth set: two steps, then a
    checkpoint that restores."""
    from yourmt3_tpu_torch.cli import train as cli
    from yourmt3_tpu_torch.data.preprocess.synth import build_synth_dataset
    monkeypatch.setenv("YMT3_DATA_HOME", str(tmp_path / "data"))
    build_synth_dataset(str(tmp_path / "data"), n_tracks=2, duration=3.0,
                        splits=("train",))
    ckpt = cli.main(["exp", "-d", "synth_smoke", "-m", "t5_tiny", "-b", "2",
                     "-s", "2", "--warmup-steps", "1", "--log-every", "1",
                     "--ckpt-every", "2", "--num-workers", "1", "--cpu",
                     "--ckpt-dir", str(tmp_path / "run")])
    assert restore_opt_state(os.path.join(ckpt, "last"))["step"] == 2
    with open(os.path.join(ckpt, "exp_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
