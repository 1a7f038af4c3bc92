"""The port's evaluation path against the JAX package's: eval/metrics.py
bit for bit on the same notes, evaluate_file_dataset on a synth_smoke set
built by the port's build_synth_dataset (t5_tiny, weights bridged from JAX, fp32),
cli.test's JSON, and the public signatures of the API and the evaluator."""

import dataclasses
import inspect
import json

import numpy as np
import pytest

import yourmt3_tpu.api as japi
import yourmt3_tpu.eval.evaluator as jevaluator
import yourmt3_tpu.eval.metrics as jmetrics
from yourmt3_tpu.config.vocabulary import DRUM_VOCABULARIES, PROGRAM_VOCABULARIES
from yourmt3_tpu.data.dataset_eval import AudioFileDataset as JaxAudioFileDataset
from yourmt3_tpu.tokens.dataclasses import Note as JaxNote
from yourmt3_tpu_torch import api
from yourmt3_tpu_torch.cli import test as cli_test
from yourmt3_tpu_torch.data.dataset_eval import AudioFileDataset
from yourmt3_tpu_torch.data.preprocess.synth import build_synth_dataset
from yourmt3_tpu_torch.eval import evaluator, metrics
from yourmt3_tpu_torch.tokens.dataclasses import Note
from yourmt3_tpu_torch.train.checkpoint import save_bundle

from torch_port_util import bridged_bundles, one_intra_op_thread  # noqa: F401

VOCABS = dict(eval_program_vocab="gm_instr_class",
              eval_drum_vocab="gm_drum_8class")


@pytest.fixture(scope="module")
def data_home(tmp_path_factory):
    """A 2-track synth_smoke test split (dataset "synth") built by the
    port's build_synth_dataset."""
    root = tmp_path_factory.mktemp("data")
    build_synth_dataset(str(root), n_tracks=2, duration=3.0,
                        splits=("test",), seed=5)
    return root


@pytest.fixture(scope="module")
def bundles():
    return bridged_bundles("t5_tiny", "mt3_full_plus_256")


def _index(data_home):
    return str(data_home / "yourmt3_indexes" / "synth_test_file_list.json")


def _jittered(notes, seed):
    """Estimates near the references: onsets and offsets moved by up to
    80 ms, a few notes dropped and a few pitches moved, drums kept."""
    rng = np.random.default_rng(seed)
    out = []
    for n in notes:
        if rng.random() < 0.15:
            continue
        on = n.onset + float(rng.uniform(-0.08, 0.08))
        off = max(on + 0.01, n.offset + float(rng.uniform(-0.08, 0.08)))
        pitch = n.pitch + (1 if rng.random() < 0.1 else 0)
        out.append((n.is_drum, n.program, on, off, pitch, n.velocity))
    return out


def _notes(seed):
    rng = np.random.default_rng(seed)
    ref = []
    for _ in range(40):
        on = float(rng.uniform(0, 8))
        if rng.random() < 0.25:
            ref.append((True, 128, on, on + 0.01, int(rng.choice([36, 38, 42])), 100))
        else:
            ref.append((False, int(rng.choice([0, 24, 33, 40, 73])), on,
                        on + float(rng.uniform(0.05, 2.0)),
                        int(rng.integers(40, 80)), 100))
    return ref


def test_metrics_equal_jax_bit_for_bit():
    """AMTMetrics (macro and per class), evaluate_track, offset_error_stats
    and precision_recall_f1 on the same seeded notes."""
    assert metrics.OFFSET_MIN_TOL == jmetrics.OFFSET_MIN_TOL
    pv, dv = VOCABS["eval_program_vocab"], VOCABS["eval_drum_vocab"]
    port = metrics.AMTMetrics(PROGRAM_VOCABULARIES[pv], DRUM_VOCABULARIES[dv])
    ref_side = jmetrics.AMTMetrics(PROGRAM_VOCABULARIES[pv], DRUM_VOCABULARIES[dv])
    for seed in range(4):
        ref = _notes(seed)
        est = _jittered([Note(*n) for n in ref], seed + 10)
        p = [Note(*n) for n in ref], [Note(*n) for n in est]
        j = [JaxNote(*n) for n in ref], [JaxNote(*n) for n in est]
        assert dataclasses.asdict(port.update(*p)) == dataclasses.asdict(ref_side.update(*j))
        assert metrics.offset_error_stats(*p) == jmetrics.offset_error_stats(*j)
    assert port.compute() == ref_side.compute()
    assert port.compute_per_class() == ref_side.compute_per_class()
    assert port.compute()["onset_f1"] > 0.3
    for counts in [(3, 5, 4), (0, 0, 0), (0, 2, 0), (7, 7, 7)]:
        assert metrics.precision_recall_f1(*counts) == jmetrics.precision_recall_f1(*counts)


def test_evaluator_matches_jax(bundles, data_home):
    """evaluate_file_dataset decoding both tracks end to end: JAX's dict."""
    jb, pb = bundles
    want = jevaluator.evaluate_file_dataset(
        jb, JaxAudioFileDataset(_index(data_home), jb.audio_cfg), batch_size=2,
        **VOCABS)
    got = evaluator.evaluate_file_dataset(
        pb, AudioFileDataset(_index(data_home), pb.audio_cfg), batch_size=2,
        **VOCABS)
    assert got == want
    assert got["num_tracks"] == 2.0 and got["decode_errors"] > 0
    assert "per_class" in got


def test_evaluator_aggregates_like_jax(bundles, data_home, monkeypatch):
    """With the decode replaced on both sides by the same estimates near
    the references, every key (per_class and the pooled offset_diagnostic
    included) equals JAX's."""
    jb, pb = bundles

    def estimates(note_cls):
        def transcribe(bundle, segments, start_times, **kw):
            seed = int(segments.sum() * 1e3) % 1000
            ds = AudioFileDataset(_index(data_home), pb.audio_cfg)
            ref = next(r for _, s, _, r in ds if np.array_equal(s, segments))
            notes = [note_cls(*n) for n in _jittered(ref, seed)]
            return notes, api.DecodeErrors(unmatched_offsets=seed % 3)
        return transcribe

    monkeypatch.setattr(jevaluator, "transcribe_segments_array", estimates(JaxNote))
    monkeypatch.setattr(evaluator, "transcribe_segments_array", estimates(Note))
    want = jevaluator.evaluate_file_dataset(
        jb, JaxAudioFileDataset(_index(data_home), jb.audio_cfg), **VOCABS)
    got = evaluator.evaluate_file_dataset(
        pb, AudioFileDataset(_index(data_home), pb.audio_cfg), **VOCABS)
    assert got == want
    assert got["onset_f1"] > 0.3 and got["offset_diagnostic"]["n_pairs"] > 5


def test_cli_test_writes_the_evaluators_json(bundles, data_home, tmp_path,
                                             monkeypatch):
    """cli.test --cpu on a checkpoint the port wrote: its JSON is JAX's
    evaluator dict on the same weights, with the preset's eval vocabs."""
    jb, pb = bundles
    ckpt = tmp_path / "ckpt"
    save_bundle(str(ckpt), pb)
    monkeypatch.setenv("YMT3_DATA_HOME", str(data_home))
    out = tmp_path / "eval.json"
    results = cli_test.main(["-ckpt", str(ckpt), "-d", "synth_smoke",
                             "--split", "test", "-b", "2", "--cpu",
                             "--output-json", str(out)])
    want = jevaluator.evaluate_file_dataset(
        jb, JaxAudioFileDataset(_index(data_home), jb.audio_cfg), batch_size=2)
    assert json.loads(out.read_text()) == {"synth": want} == results


@pytest.mark.parametrize("name", ["transcribe_segments_array",
                                  "transcribe_audio_array", "transcribe",
                                  "evaluate_file_dataset"])
def test_signatures_match_jax(name):
    """Parameter names, order, kinds and defaults equal JAX's, so a call by
    position means the same in both packages."""
    if name == "evaluate_file_dataset":
        port, ref = evaluator.evaluate_file_dataset, jevaluator.evaluate_file_dataset
    else:
        port, ref = getattr(api, name), getattr(japi, name)

    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]

    assert params(port) == params(ref)
