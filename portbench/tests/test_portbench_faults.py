"""A run with the timed path broken underneath comes out not correct,
with each cell's own limits: once for each fault the cell can have. The
harness's look for a card is skipped; the rest of a run is driven on the
CPU at tiny widths. A sound run at the same size reads low.

Faults: a training step that returns its state unchanged; half of the
batch left out, the mean taken over the rest; a token, or the loss,
altered where it is produced. The exchange between chips does not exist
in these one-chip cells."""

import time

import pytest
import torch

from harness import core
from pb_tiny import tiny_cell

torch.set_num_threads(2)


def drive(name: str, seed: int = 21) -> core.Run:
    cell = tiny_cell(name)
    return core.driver(cell).run(cell, seed, 0.0, False, torch.device("cpu"),
                                 time.perf_counter())


# A sound run at tiny widths is held to TINY times the cell's limits: its
# tensors are small, so bf16's rounding weighs more in the worst one (tiny
# moe.train reads grad_gap 0.008-0.029 and change_gap 0.002-0.010 on
# seeds 21-23; at the cell's size at most 0.0142 and 0.0055 over 40
# seeds). Every fault below reads far above the limits themselves.
TINY = 4.0


TRANSCRIBE = ["mc13.transcribe", "t5_small.transcribe"]


@pytest.mark.parametrize("name", TRANSCRIBE + ["mc13.train", "moe.train"])
def test_sound_run_reads_low(name):
    run = drive(name)
    for check in run.checks.values():
        assert check["value"] <= TINY * check["limit"], run.checks


@pytest.mark.parametrize("name", TRANSCRIBE)
def test_transcribe_token_altered(monkeypatch, name):
    from yourmt3_tpu_torch import api
    greedy = api.greedy_decode

    def altered(model, memory, max_length, **kw):
        ids = greedy(model, memory, max_length, **kw)
        mid = ids.shape[-1] // 2
        ids[:, :, mid] = (ids[:, :, mid] + 17) % model.cfg.vocab_size
        return ids
    monkeypatch.setattr(api, "greedy_decode", altered)
    run = drive(name)
    assert not run.correct and run.checks["token_gap"]["value"] > run.checks[
        "token_gap"]["limit"]


@pytest.mark.parametrize("name", TRANSCRIBE)
def test_transcribe_half_batch_left_out(monkeypatch, name):
    from yourmt3_tpu_torch import api
    greedy = api.greedy_decode

    def half(model, memory, max_length, **kw):
        ids = greedy(model, memory, max_length, **kw)
        ids[ids.shape[0] // 2:] = 2  # UNK where the rows were skipped
        return ids
    monkeypatch.setattr(api, "greedy_decode", half)
    assert not drive(name).correct


@pytest.mark.parametrize("name", ["mc13.train", "moe.train"])
def test_train_state_unchanged(monkeypatch, name):
    from yourmt3_tpu_torch.train import optim, trainer
    make = trainer.make_optimizer

    def frozen(*a, **k):
        tx = make(*a, **k)
        return optim.GradientTransformation(
            tx.init, lambda g, s, p=None: ({n: torch.zeros_like(v) for n, v in g.items()}, s))
    monkeypatch.setattr(trainer, "make_optimizer", frozen)
    run = drive(name)
    assert not run.correct and run.checks["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["mc13.train", "moe.train"])
def test_train_half_batch_left_out(monkeypatch, name):
    from yourmt3_tpu_torch.train import train_step
    device_batch = train_step._device_batch

    def half(batch, device):
        audio, labels = device_batch(batch, device)
        labels = labels.clone()
        labels[labels.shape[0] // 2:] = 0  # pad: the mean is over the rest
        return audio, labels
    monkeypatch.setattr(train_step, "_device_batch", half)
    assert not drive(name).correct


def test_train_loss_altered(monkeypatch):
    from yourmt3_tpu_torch.train import train_step
    sums = train_step.ce_sums

    def altered(logits, labels, smoothing=0.0):
        nll, correct, count = sums(logits, labels, smoothing)
        return nll * 1.05, correct, count
    monkeypatch.setattr(train_step, "ce_sums", altered)
    assert not drive("mc13.train").correct
