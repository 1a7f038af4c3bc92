"""The plain reference against the port on the CPU at tiny widths: the
same names and shapes, the same logits in float32, the same masks and
loss in a training step, the same notes from the same ids. The test
imports both; the reference imports nothing of the port."""

import os

import numpy as np
import pytest
import torch

from harness import bundle as hb
from harness import core, inputs
from reference import model as ref
from reference import serve_check, train_check
from pb_tiny import tiny_cell

torch.set_num_threads(2)
FP32 = {"compute_dtype": "float32"}
# one cell of each configuration
BY_CONFIG = sorted({w["config"]: w["name"] for w in core.read_json(
    os.path.join(core.REPO, "BENCHMARK.json"))["workloads"]}.values())


@pytest.mark.parametrize("workload", BY_CONFIG)
def test_names_shapes_and_logits(workload):
    cell = tiny_cell(workload)
    b = hb.build(cell.config, "cpu", 11, overrides=FP32)
    cfg = b.cfg.__dict__
    shapes = ref.param_shapes(dict(cell.config, model=cfg))
    assert shapes == {k: tuple(v.shape) for k, v in b.model.state_dict().items()}
    params = dict(b.model.state_dict())
    g = inputs.rng(3, 0)
    audio = torch.from_numpy(g.standard_normal((2, b.audio_cfg.input_frames),
                                               dtype=np.float32) * 0.1)
    ids = torch.from_numpy(g.integers(0, cfg["vocab_size"], (2, cfg["num_channels"], 16)))
    with torch.no_grad():
        feats = b.frontend(audio)
        want = b.model(feats, ref.shift_right(ids))
        got = ref.logits(params, audio, ids, dict(cell.config, model=cfg))
        ref_feats = ref.features(audio, cell.config["audio"])
    assert float((ref_feats - feats).abs().max()) < 2e-3
    # the port's group projection computes in bf16 whatever the compute
    # dtype, so its memory carries bf16 rounding (2^-9): allow 2^-8
    assert float((got - want).abs().max()) < 2 ** -8 * float(want.abs().max())


def test_train_step_masks_and_loss_match_in_float32():
    """Dropout and SpecAugment on: the reference's masks are the trainer's,
    so its losses, gradient and change follow a float32 program closely."""
    cell = tiny_cell("mc13.train")
    cell.config["model"].update(FP32)
    run = core.driver(cell).run(cell, 5, 0.0, False, torch.device("cpu"), 0.0)
    # what is left is the port's bf16 group projection (8e-5 in the loss
    # on this seed); masks drawn apart would move the loss by about 1e-2
    assert run.checks["loss_gap"]["value"] < 3e-4
    assert run.checks["grad_gap"]["value"] < 1e-2
    assert run.checks["change_gap"]["value"] < 3e-3


def test_masks_matter():
    """Another mask stream moves the loss far more than rounding does."""
    cell = tiny_cell("mc13.train")
    batches = inputs.train_batches(1, cell.traffic, 32767, 13, 256, 597, 16000)[:1]
    a = train_check.reference_steps(cell.config, 1, batches, "cpu", 1)
    b = train_check.reference_steps(cell.config, 1, batches, "cpu", 2)
    assert a["losses"] == pytest.approx(b["losses"], rel=1e-5)  # blocks of rows
    cell.config["train"]["spec_augment"] = False
    c = train_check.reference_steps(cell.config, 1, batches, "cpu", 1)
    assert abs(c["losses"][0] - a["losses"][0]) > 1e-3 * a["losses"][0]


def test_reference_detokenizer_equals_the_ports():
    from yourmt3_tpu_torch.tokens.task_manager import TaskManager
    cell = tiny_cell("mc13.transcribe")
    tm = TaskManager(cell.config["task"])
    g = np.random.default_rng(0)
    ids = g.integers(0, tm.vocab_size, (3, 13, 64))
    ids[:, :, 40] = 1
    starts = [i * tm.audio_cfg.segment_seconds for i in range(3)]
    want = serve_check.reference_detok(cell.config, ids, starts)
    for fast in (True, False):
        got, _ = tm.detokenize_song(torch.from_numpy(ids) if fast else ids, starts,
                                    fast=fast)
        assert sorted(map(serve_check.note_key, got)) == sorted(
            map(serve_check.note_key, want))


def test_live_positions_end_at_eos():
    ids = torch.tensor([[5, 1, 0, 0], [5, 6, 7, 8], [1, 0, 0, 0]])
    assert serve_check.live(ids).tolist() == [[True, True, False, False],
                                              [True] * 4,
                                              [True, False, False, False]]
