"""The port's vectorized detokenizer (tokens/fast_detok.py) against the
JAX package's: the extracted arrays, the notes and every error count, on
seeded id streams, well-formed and malformed; and the port's Python walk
(fast=False) against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

from yourmt3_tpu.tokens.fast_detok import FastDetokenizer as JaxFastDetokenizer
from yourmt3_tpu.tokens.task_manager import TaskManager as JaxTaskManager
from yourmt3_tpu_torch.tokens.dataclasses import Event, Note
from yourmt3_tpu_torch.tokens.fast_detok import FastDetokenizer
from yourmt3_tpu_torch.tokens.task_manager import TaskManager

SEG = 32767 / 16000
TASKS = ("mt3_full_plus_256", "mc13_full_plus_256")


@pytest.fixture(scope="module")
def managers():
    return {t: (JaxTaskManager(t), TaskManager(t)) for t in TASKS}


def _ids(codec, events, L):
    """Events (or raw ids) → one (L,) stream, EOS-terminated, PAD-filled."""
    row = [e if isinstance(e, int) else codec.encode_event(Event(*e))
           for e in events][: L - 1] + [1]
    return np.asarray(row + [0] * (L - len(row)), np.int64)


def _random_events(rng, codec, n, no_tie=False, nonmono=False, drums=False,
                   garbage=False):
    """A random event stream: a tie section (unless no_tie), then shifts,
    programs, velocities (0 = offset), pitches, and optionally drums,
    shifts that go backwards and ids outside the vocabulary."""
    events = []
    if not no_tie:
        for _ in range(rng.integers(0, 3)):
            events += [("program", int(rng.choice([0, 24, 33]))),
                       ("pitch", int(rng.integers(40, 80)))]
        events.append(("tie", 0))
    t = 0
    for _ in range(n):
        r = rng.random()
        if r < 0.25:
            t = (max(1, t - int(rng.integers(1, 50))) if nonmono and rng.random() < 0.3
                 else min(codec.max_shift_steps, t + int(rng.integers(1, 40))))
            events.append(("shift", t))
        elif r < 0.35:
            events.append(("program", int(rng.choice([0, 24, 33, 40]))))
        elif r < 0.5:
            events.append(("velocity", int(rng.integers(0, 2))))
        elif r < 0.6 and drums:
            events.append(("drum", int(rng.choice([36, 38, 42]))))
        elif r < 0.65 and garbage:
            events.append(int(rng.integers(codec.vocab_size, codec.vocab_size + 40)))
        else:
            events.append(("pitch", int(rng.integers(40, 80))))
    return events


def _streams(codec, channels, seed, L=96, **kind):
    rng = np.random.default_rng(seed)
    return np.stack([np.stack([_ids(codec, _random_events(rng, codec, 40, **kind), L)
                               for _ in range(channels)]) for _ in range(3)])


KINDS = {"well_formed": {}, "no_tie": {"no_tie": True},
         "nonmonotonic": {"nonmono": True}, "drums": {"drums": True},
         "garbage": {"garbage": True, "drums": True, "nonmono": True}}


def _astuples(notes):
    return [dataclasses.astuple(n) for n in notes]


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_fast_detokenizer_matches_jax(managers, task, kind):
    """extract (every key, same dtype), then detokenize_song fast=True and
    fast=False: the same notes and every DecodeErrors field."""
    jtm, tm = managers[task]
    C = tm.num_decoding_channels
    ids = _streams(tm.codec, C, seed=len(kind) + C, **KINDS[kind])
    starts = [0.0, SEG, 2 * SEG]
    defaults = np.tile(np.asarray(tm.channel_default_programs, np.int32), 3)
    want = JaxFastDetokenizer(jtm.codec).extract(ids.astype(np.int32), defaults)
    got = FastDetokenizer(tm.codec).extract(torch.from_numpy(ids), defaults)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for fast in (True, False):
        notes_j, err_j = jtm.detokenize_song(ids.astype(np.int32), starts, fast=fast)
        notes_p, err_p = tm.detokenize_song(torch.from_numpy(ids), starts, fast=fast)
        assert _astuples(notes_p) == _astuples(notes_j), fast
        assert dataclasses.astuple(err_p) == dataclasses.astuple(err_j), fast
    assert len(notes_p) > 0


@pytest.mark.parametrize("task", TASKS)
def test_tokenized_songs_round_trip_like_jax(managers, task):
    """Label streams of a seeded song (ties across segments, drums,
    overlapping notes of one pitch): the fast path gives JAX's notes and
    error counts."""
    jtm, tm = managers[task]
    rng = np.random.default_rng(3)
    song = []
    for _ in range(30):
        on = float(rng.uniform(0, 5.5))
        if rng.random() < 0.2:
            song.append(Note(True, 128, on, on + 0.01, int(rng.choice([36, 38])), 100))
        else:
            song.append(Note(False, int(rng.choice([0, 24, 33])), on,
                             on + float(rng.uniform(0.1, 2.5)),
                             int(rng.integers(40, 80)), 100))
    starts = [i * SEG for i in range(3)]
    ids = tm.tokenize_song(song, starts)
    notes_j, err_j = jtm.detokenize_song(ids, starts)
    notes_p, err_p = tm.detokenize_song(ids, starts)
    assert _astuples(notes_p) == _astuples(notes_j)
    assert dataclasses.astuple(err_p) == dataclasses.astuple(err_j)
    assert len(notes_p) > 10


def test_no_tie_stream_counts_as_the_reference_fast_path(managers):
    """shift, program, velocity, pitch, shift, velocity 0, pitch, EOS with
    no tie token: the walk counts the four non-declaration events of the
    'tie section' as dropped, the fast path (the reference's default)
    counts none; the notes and the tie count agree."""
    jtm, tm = managers["mt3_full_plus_256"]
    events = [("shift", 10), ("program", 0), ("velocity", 1), ("pitch", 60),
              ("shift", 50), ("velocity", 0), ("pitch", 60)]
    ids = _ids(tm.codec, events, 16)[None]
    errs = {}
    for fast in (True, False):
        notes_p, err_p = tm.detokenize_song(ids, [0.0], fast=fast)
        notes_j, err_j = jtm.detokenize_song(ids, [0.0], fast=fast)
        assert _astuples(notes_p) == _astuples(notes_j)
        assert dataclasses.astuple(err_p) == dataclasses.astuple(err_j)
        errs[fast] = err_p
    assert errs[True].dropped_events == 0 and errs[False].dropped_events == 4
    assert errs[True].tie_without_active_note == errs[False].tie_without_active_note == 1


def test_fast_path_takes_tensors_and_arrays_alike(managers):
    """Ids as an int64 tensor, an int32 array and a 2-D (S, L) array give
    the same notes and errors."""
    _, tm = managers["mt3_full_plus_256"]
    ids = _streams(tm.codec, 1, seed=11, drums=True)
    starts = [0.0, SEG, 2 * SEG]
    ref = tm.detokenize_song(torch.from_numpy(ids), starts)
    for other in (ids.astype(np.int32), ids[:, 0]):
        notes, err = tm.detokenize_song(other, starts)
        assert _astuples(notes) == _astuples(ref[0]) and err == ref[1]
