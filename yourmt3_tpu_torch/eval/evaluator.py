"""Full transcription evaluation: decode whole files, compute F1 tables.

Per track: segment-batch greedy decode (api.transcribe_segments_array) →
detokenize → cross-segment merge → AMTMetrics; per-dataset metric tables
with eval-vocab remapping, as the reference package's evaluator gives
them. With `mesh` (a process group) each song's segments are decoded
chunk-parallel over its ranks (parallel/chunk_stream.py); every rank
returns the same metrics.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..api import ModelBundle, resolve_device, transcribe_segments_array
from ..config.vocabulary import (DRUM_VOCABULARIES, PROGRAM_VOCABULARIES,
                                 DrumVocabulary, InstrumentVocabulary)
from ..data.dataset_eval import AudioFileDataset
from ..parallel.chunk_stream import transcribe_song_chunk_parallel
from ..parallel.mesh import rank
from .metrics import OFFSET_MIN_TOL, AMTMetrics, offset_error_stats


def evaluate_file_dataset(
    bundle: ModelBundle,
    dataset: AudioFileDataset,
    eval_program_vocab: Optional[str] = None,
    eval_drum_vocab: Optional[str] = None,
    batch_size: int = 8,
    subtask: Optional[str] = None,
    verbose: bool = True,
    mesh=None,  # a process group → chunk-parallel song streaming
    segments_per_device: int = 2,
    beam_size: int = 1,  # >1: batched beam search per segment
    repetition_guard: int = 0,  # >0: degenerate-decode cutoff (api)
    repair_beam: int = 0,  # >1: validate-and-repair decode (api)
) -> Dict[str, float]:
    """→ macro-averaged metric dict over the dataset's tracks, with
    `decode_errors`, `num_tracks`, `per_class` (per-instrument-class onset
    P/R/F1) and `offset_diagnostic` (signed offset errors pooled over the
    tracks' matched pairs) beside the metrics.

    With `mesh`, each song's segment axis is split over the group's ranks
    in tiles of `segments_per_device` per rank; with segments_per_device
    equal to `batch_size` at world 1 the metrics equal the single-device
    path's. That path takes plain greedy decoding of contiguous segments
    only: beam search, the repetition guard and the repair decode raise
    (the reference's mesh path ignores repair_beam; the port refuses it
    rather than score another decode)."""
    resolve_device(bundle.device)
    verbose = verbose and (mesh is None or rank(mesh) == 0)
    pv: Optional[InstrumentVocabulary] = (
        PROGRAM_VOCABULARIES[eval_program_vocab] if eval_program_vocab else None)
    dv: Optional[DrumVocabulary] = (
        DRUM_VOCABULARIES[eval_drum_vocab] if eval_drum_vocab else None)
    metrics = AMTMetrics(pv, dv)
    total_err = 0
    offset_errs: list = []  # per-track offset_error_stats
    for track_id, segments, start_times, ref_notes in dataset:
        if mesh is not None:
            if beam_size > 1:
                raise ValueError("beam_size>1 is not supported on the "
                                 "chunk-parallel mesh path; use mesh=None")
            if repetition_guard > 0:
                raise ValueError("repetition_guard>0 is not threaded through "
                                 "the chunk-parallel mesh path; use mesh=None")
            if repair_beam > 1:
                raise ValueError("repair_beam>1 is not threaded through the "
                                 "chunk-parallel mesh path; use mesh=None")
            # the mesh path re-slices the flat song, so it is only valid for
            # contiguous non-overlapping segments
            seg_s = bundle.audio_cfg.input_frames / bundle.audio_cfg.sample_rate
            expected = [i * seg_s for i in range(len(start_times))]
            if any(abs(a - b) > 1e-6 for a, b in zip(start_times, expected)):
                raise ValueError(
                    "mesh eval requires contiguous non-overlapping segments "
                    f"(got start_times {list(start_times)[:4]}…, expected "
                    f"multiples of {seg_s:.3f}s); use mesh=None for custom "
                    "slicers")
            audio_flat = segments.reshape(-1)[
                : segments.shape[0] * bundle.audio_cfg.input_frames]
            est_notes, err = transcribe_song_chunk_parallel(
                bundle, audio_flat, mesh,
                segments_per_device=segments_per_device, subtask=subtask)
        else:
            est_notes, err = transcribe_segments_array(
                bundle, segments, start_times,
                batch_size=batch_size, subtask=subtask,
                beam_size=beam_size, repetition_guard=repetition_guard,
                repair_beam=repair_beam)
        total_err += err.total()
        ref = bundle.task_manager.remap_notes(ref_notes)
        offset_errs.append(offset_error_stats(ref, est_notes))
        s = metrics.update(ref, est_notes)
        if verbose:
            fmt = lambda v: "n/a" if v is None else f"{v:.4f}"
            print(f"  {track_id}: onset_f1={fmt(s.onset_f1)} "
                  f"offset_f1={fmt(s.offset_f1)} multi_f1={fmt(s.multi_f1)} "
                  f"drum_f1={fmt(s.drum_f1)}")
    out = metrics.compute()
    out["decode_errors"] = float(total_err)
    out["num_tracks"] = float(metrics.num_tracks)
    per_class = metrics.compute_per_class()
    if per_class:
        out["per_class"] = per_class
    # pool the raw signed errors across tracks before the aggregate
    # median/std: a weighted mean of per-track medians is not the pooled
    # median
    pooled = np.asarray([e for o in offset_errs
                         for e in o.get("raw_errors_s", ())])
    if pooled.size:
        out["offset_diagnostic"] = {
            "n_pairs": float(pooled.size),
            "mean_signed_s": float(pooled.mean()),
            "median_signed_s": float(np.median(pooled)),
            "std_s": float(pooled.std()),
            "p_early": float((pooled < -OFFSET_MIN_TOL).mean()),
            "p_late": float((pooled > OFFSET_MIN_TOL).mean()),
            "p_within_tol": float((np.abs(pooled) <= OFFSET_MIN_TOL).mean()),
        }
    return out
