"""The serving check of a task whose rows start with forced tokens: the
prefix is encoded by the reference codec, its positions are not judged by
`token_gap`, and `prefix_mismatch` counts the rows that do not carry it.
A tiny prefixed cell (`t5_small.transcribe`) is run once on the CPU, then
its check is run again on altered copies of what the window served; an
unprefixed cell reads as it did before prefixes were judged."""

import copy
import time

import numpy as np
import pytest
import torch

from harness import core, inputs, weights
from reference import model as ref
from reference import serve_check
from pb_tiny import tiny_cell

torch.set_num_threads(2)


def captured_run(name: str, seed: int = 23):
    """A tiny run of `name` and the arguments its driver gave the check."""
    cell = tiny_cell(name)
    drv = core.driver(cell)
    seen = {}
    check = serve_check.check

    def keep(*args, **kw):
        seen["args"], seen["kw"] = copy.deepcopy(args), kw
        return check(*args, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(drv.serve_check, "check", keep)
        run = drv.run(cell, seed, 0.0, False, torch.device("cpu"), time.perf_counter())
    return run, seen["args"], seen["kw"]


def recheck(args, kw, alter):
    config, seed, songs, captured, *rest = copy.deepcopy(args)
    for song in captured:
        for d in song["decodes"]:
            if d["kind"] == "greedy":
                alter(d["ids"])
    return serve_check.check(config, seed, songs, captured, *rest, **kw)


@pytest.fixture(scope="module")
def prefixed():
    return captured_run("t5_small.transcribe")


def test_prefix_is_the_ports_task_token():
    from yourmt3_tpu_torch.tokens.task_manager import TaskManager
    cell = tiny_cell("t5_small.transcribe")
    assert serve_check.prefix_ids(cell.config) == TaskManager(
        cell.config["task"]).subtask_prefix_ids() == [597]


def test_rows_that_carry_the_prefix_pass(prefixed):
    run, _, _ = prefixed
    assert run.correct, run.checks
    assert set(run.checks) == {"token_gap", "note_mismatch", "prefix_mismatch"}
    assert run.checks["prefix_mismatch"]["value"] == 0


def test_a_changed_forced_token_is_one_mismatch(prefixed):
    _, args, kw = prefixed

    def change(ids):
        if change.done:
            return
        ids[0, 0, 0] = 5  # one row's forced token
        change.done = True
    change.done = False
    checks = recheck(args, kw, change)
    assert checks["prefix_mismatch"]["value"] == 1
    assert checks["prefix_mismatch"]["value"] > checks["prefix_mismatch"]["limit"]


def test_a_wrong_token_just_past_the_prefix_raises_token_gap(prefixed):
    _, args, kw = prefixed
    P = len(args[0]["prefix"])
    vocab = args[0]["model"]["vocab_size"]

    def wrong(ids):
        ids[:, :, P] = (ids[:, :, P] + 17) % vocab
    checks = recheck(args, kw, wrong)
    assert checks["prefix_mismatch"]["value"] == 0
    assert checks["token_gap"]["value"] > checks["token_gap"]["limit"]


def test_the_forced_positions_are_left_out_of_token_gap(prefixed):
    """The program writes the forced token whatever the model's logits say:
    judged from position 0, sound rows would fail the limit; past it, they
    read what the check reports."""
    _, args, kw = prefixed
    config, seed, songs, captured = args[:4]
    params = weights.for_config(config, ref.param_shapes(config), seed, "cpu")
    song = captured[0]
    audio = songs[song["song"]]
    greedy, beam = serve_check.served(
        song, len(inputs.segments(audio, config["audio"]["input_frames"])))
    past, _ = serve_check.gaps(config, params, audio, greedy, beam, "cpu", 2, forced=1)
    every, _ = serve_check.gaps(config, params, audio, greedy, beam, "cpu", 2, forced=0)
    assert past == pytest.approx(recheck(args, kw, lambda ids: None)["token_gap"]["value"])
    assert every > args[6]["token_gap"] > past


def test_an_unprefixed_cell_reads_as_before():
    """mc13.transcribe has no prefix: the same two numbers, token_gap the
    widest gap over every position up to and with EOS, as before forced
    prefixes were judged."""
    run, args, kw = captured_run("mc13.transcribe")
    assert set(run.checks) == {"token_gap", "note_mismatch"}
    config, seed, songs, captured = args[:4]
    assert serve_check.prefix_ids(config) == []
    params = weights.for_config(config, ref.param_shapes(config), seed, "cpu")
    widest = 0.0
    for song in captured:
        audio = songs[song["song"]]
        segs = inputs.segments(audio, config["audio"]["input_frames"])
        greedy, beam = serve_check.served(song, len(segs))
        rows = [(False, s, greedy[s]) for s in range(len(segs))]
        rows += [(True, s, b) for s, b in sorted(beam.items())]
        for is_beam, s, ids in rows:
            ids = torch.from_numpy(np.asarray(ids))[None]
            lg = ref.logits(params, torch.from_numpy(segs[[s]]), ids, config)
            best = torch.topk(lg, 2, dim=-1).values[..., 1 if is_beam else 0]
            tok = torch.gather(lg, -1, ids[..., None])[..., 0]
            gap = torch.clamp(best - tok, min=0)[serve_check.live(ids)]
            widest = max(widest, float(gap.max()))
    assert run.checks["token_gap"]["value"] == pytest.approx(widest, rel=1e-5, abs=1e-6)
