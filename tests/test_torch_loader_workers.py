"""The port's training loader with two producer processes and cross-track
stem submix, against the JAX package's copy of the loader with the same
seed: the smallest synth set of the JAX package's tests plus the two
stem datasets of tests/test_cross_submix.py, mixed with
cross_submix_prob > 0.

`batches(num_workers=2)` hands each spawned producer one child of a seed
sequence drawn from the dataset's generator; a producer's batches come in
its own order, the two producers' interleave as they finish. So each
producer's stream is computed in this process from the JAX copy with the
same seeds, and the port's batches must be an interleaving of those
streams' prefixes, element for element. Counts, not wall-clock time: the
number of batches taken and of cross-track submixes drawn."""

import numpy as np
import pytest

from test_cross_submix import _make_stem_track
from yourmt3_tpu.data import augment as jax_augment
from yourmt3_tpu.data.dataset_train import TrainDataset as JaxTrainDataset
from yourmt3_tpu.data.indexes import write_file_list
from yourmt3_tpu.data.preprocess.synth import build_synth_dataset
from yourmt3_tpu.tokens.dataclasses import Note
from yourmt3_tpu.tokens.task_manager import TaskManager as JaxTaskManager
from yourmt3_tpu_torch.data import augment as port_augment
from yourmt3_tpu_torch.data.dataset_train import TrainDataset
from yourmt3_tpu_torch.tokens.task_manager import TaskManager

WORKERS, BATCH, TAKEN = 2, 2, 4
OPTIONS = dict(cross_submix_prob=0.6, submix_p_include=0.8, seed=7)


@pytest.fixture(scope="module")
def file_lists(tmp_path_factory):
    root = tmp_path_factory.mktemp("loader")
    synth = build_synth_dataset(str(root), n_tracks=2, duration=2.0, splits=("train",),
                                seed=11, dataset_name="ldr")["train"]
    lists = [synth]
    for ds, tid, stems in (
            ("dsA", "a0", {"piano": [Note(False, 0, 0.10, 0.60, 60, 90)],
                           "bass": [Note(False, 32, 0.20, 0.90, 40, 80)]}),
            ("dsB", "b0", {"guitar": [Note(False, 24, 0.15, 0.70, 55, 85)],
                           "drums": [Note(True, 128, 0.30, 0.31, 38, 100)]})):
        path = str(root / "yourmt3_indexes" / f"{ds}_train_file_list.json")
        write_file_list(path, [_make_stem_track(str(root), ds, tid, stems)], ds, "train")
        lists.append(path)
    return lists


def _counting(module, monkeypatch):
    calls = []
    inner = module.cross_track_submix

    def counted(*a, **kw):
        calls.append(1)
        return inner(*a, **kw)
    monkeypatch.setattr(module, "cross_track_submix", counted)
    return calls


def _streams(ds, n):
    """Each producer's first n batches, made in this process from the seeds
    batches() would hand it."""
    seeds = np.random.SeedSequence(int(ds.rng.integers(0, 2**63 - 1))).spawn(WORKERS)
    out = []
    for s in seeds:
        rng = np.random.default_rng(s)
        out.append([ds.make_batch(BATCH, rng) for _ in range(n)])
    return out


def _same(a, b):
    return sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_producer_streams_equal_the_jax_copy(file_lists, monkeypatch):
    """In this process, the port's and the JAX copy's producer streams from
    the same seed are equal batch for batch, cross-track submixes included."""
    jax_calls = _counting(jax_augment, monkeypatch)
    port_calls = _counting(port_augment, monkeypatch)
    want = _streams(JaxTrainDataset(file_lists, JaxTaskManager("mt3_full_plus"),
                                    **OPTIONS), TAKEN)
    got = _streams(TrainDataset(file_lists, TaskManager("mt3_full_plus"), **OPTIONS),
                   TAKEN)
    assert len(jax_calls) == len(port_calls) > 0
    for w in range(WORKERS):
        for g, j in zip(got[w], want[w]):
            assert _same(g, j)


def test_two_producer_processes_give_the_jax_copys_batches(file_lists):
    """batches(num_workers=2) spawns two producers: the first TAKEN batches
    interleave the JAX copy's producer streams, each in its order."""
    want = _streams(JaxTrainDataset(file_lists, JaxTaskManager("mt3_full_plus"),
                                    **OPTIONS), TAKEN)
    it = TrainDataset(file_lists, TaskManager("mt3_full_plus"), **OPTIONS).batches(
        BATCH, num_workers=WORKERS)
    try:
        got = [next(it) for _ in range(TAKEN)]
    finally:
        it.close()  # stops the producers
    taken = [0] * WORKERS
    for b in got:
        w = next((w for w in range(WORKERS) if _same(b, want[w][taken[w]])), None)
        assert w is not None, "a batch that no producer stream holds next"
        taken[w] += 1
    assert sum(taken) == TAKEN
