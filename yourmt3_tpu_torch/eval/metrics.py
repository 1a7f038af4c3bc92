"""Transcription metrics: note-onset / onset+offset / multi-instrument /
drum F1, first-party (mir_eval is not available in this stack; semantics
follow mir_eval.transcription so numbers are comparable).

Capability parity target: reference `utils/metrics.py` `AMTMetrics`
(SURVEY.md C27): instrument-agnostic onset F1 (50 ms tol), onset+offset F1
(offset tol = max(50 ms, 0.2·duration)), multi-instrument F1 grouped by an
eval vocabulary, drum onset F1; macro-averaged over tracks.

Matching is maximum-cardinality bipartite matching over valid (ref, est)
pairs — identical to mir_eval.transcription.match_notes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import maximum_bipartite_matching

from ..config.vocabulary import (DRUM_PROGRAM, DrumVocabulary,
                                 InstrumentVocabulary)
from ..tokens.dataclasses import Note

ONSET_TOL = 0.05
OFFSET_RATIO = 0.2
OFFSET_MIN_TOL = 0.05


def _match_count(
    ref: Sequence[Tuple[float, float, int]],
    est: Sequence[Tuple[float, float, int]],
    onset_tol: float = ONSET_TOL,
    with_offset: bool = False,
) -> int:
    """Max-cardinality matching size between (onset, offset, key) tuples."""
    if not ref or not est:
        return 0
    r_on = np.array([r[0] for r in ref])
    r_off = np.array([r[1] for r in ref])
    r_key = np.array([r[2] for r in ref])
    e_on = np.array([e[0] for e in est])
    e_off = np.array([e[1] for e in est])
    e_key = np.array([e[2] for e in est])

    ok = (np.abs(r_on[:, None] - e_on[None, :]) <= onset_tol) & (
        r_key[:, None] == e_key[None, :])
    if with_offset:
        tol = np.maximum(OFFSET_MIN_TOL, OFFSET_RATIO * (r_off - r_on))
        ok &= np.abs(r_off[:, None] - e_off[None, :]) <= tol[:, None]
    if not ok.any():
        return 0
    graph = csr_matrix(ok)
    match = maximum_bipartite_matching(graph, perm_type="column")
    return int((match >= 0).sum())


def precision_recall_f1(n_match: int, n_ref: int, n_est: int
                        ) -> Tuple[float, float, float]:
    p = n_match / n_est if n_est else 0.0
    r = n_match / n_ref if n_ref else 0.0
    f = 2 * p * r / (p + r) if (p + r) else 0.0
    return p, r, f


def _tuples(notes: Sequence[Note], key_fn) -> List[Tuple[float, float, int]]:
    out = []
    for n in notes:
        k = key_fn(n)
        if k is not None:
            out.append((n.onset, n.offset, k))
    return out


@dataclasses.dataclass
class TrackScores:
    """Per-track scores. `None` means "not evaluated on this track" (e.g.
    drum_f1 on a track with no drums anywhere) — macro averaging skips it,
    matching the reference's per-metric MeanMetric accumulators which are
    only updated when the metric is computed."""

    onset_f1: Optional[float] = None
    offset_f1: Optional[float] = None  # onset+offset
    multi_f1: Optional[float] = None
    drum_f1: Optional[float] = None
    onset_precision: Optional[float] = None
    onset_recall: Optional[float] = None
    multi_precision: Optional[float] = None
    multi_recall: Optional[float] = None
    # per-class onset match counts {class_name: (n_match, n_ref, n_est)} —
    # raw counts (not rates) so tracks micro-aggregate; excluded from the
    # scalar macro-averaging in AMTMetrics.compute()
    class_counts: Optional[Dict[str, Tuple[int, int, int]]] = None


def evaluate_track(
    ref_notes: Sequence[Note],
    est_notes: Sequence[Note],
    eval_program_vocab: Optional[InstrumentVocabulary] = None,
    eval_drum_vocab: Optional[DrumVocabulary] = None,
    onset_tolerance: float = ONSET_TOL,
) -> TrackScores:
    """Full per-track metric set.

    - onset/offset F1 are instrument-agnostic over PITCHED notes (drums are
      excluded, as in the reference);
    - multi_f1 groups pitched notes by eval-vocab class (drums form one
      extra class when the vocab has drums);
    - drum_f1 matches drums by drum-class with onset tolerance only.
    """
    s = TrackScores()
    ref_p = [n for n in ref_notes if not n.is_drum]
    est_p = [n for n in est_notes if not n.is_drum]
    ref_d = [n for n in ref_notes if n.is_drum]
    est_d = [n for n in est_notes if n.is_drum]

    # instrument-agnostic pitched (undefined when the track has no pitched
    # content in either ref or est — a pure-drum track)
    rt = _tuples(ref_p, lambda n: n.pitch)
    et = _tuples(est_p, lambda n: n.pitch)
    if rt or et:
        m = _match_count(rt, et, onset_tolerance, with_offset=False)
        s.onset_precision, s.onset_recall, s.onset_f1 = precision_recall_f1(
            m, len(rt), len(et))
        m = _match_count(rt, et, onset_tolerance, with_offset=True)
        _, _, s.offset_f1 = precision_recall_f1(m, len(rt), len(et))

    # multi-instrument (flat micro matching with class-qualified pitch)
    if eval_program_vocab is not None:
        p2c = eval_program_vocab.program_to_class_array()

        def mkey(n: Note) -> Optional[int]:
            prog = DRUM_PROGRAM if n.is_drum else n.program
            c = int(p2c[prog]) if 0 <= prog <= DRUM_PROGRAM else -1
            if c < 0:
                return None
            return c * 1000 + n.pitch

        ref_all = [n for n in ref_notes]
        est_all = [n for n in est_notes]
        rt = _tuples(ref_all, mkey)
        et = _tuples(est_all, mkey)
        if rt or et:
            m = _match_count(rt, et, onset_tolerance, with_offset=False)
            s.multi_precision, s.multi_recall, s.multi_f1 = precision_recall_f1(
                m, len(rt), len(et))

    # per-class onset F1 (diagnostic breakdown of multi_f1: same
    # class-qualified matching, micro within each class; reference test.py
    # prints per-dataset tables — this is the per-instrument-class row set)
    if eval_program_vocab is not None:
        s.class_counts = {}
        names = eval_program_vocab.class_names()
        for c, name in enumerate(names):
            rc = [t for t in rt if t[2] // 1000 == c]
            ec = [t for t in et if t[2] // 1000 == c]
            if not (rc or ec):
                continue
            m = _match_count(rc, ec, onset_tolerance, with_offset=False)
            s.class_counts[name] = (m, len(rc), len(ec))

    # drums
    if ref_d or est_d:
        if eval_drum_vocab is not None:
            d2c = eval_drum_vocab.note_to_class_array()

            def dkey(n: Note) -> Optional[int]:
                c = int(d2c[n.pitch]) if 0 <= n.pitch < 128 else -1
                return None if c < 0 else c
        else:
            def dkey(n: Note) -> Optional[int]:
                return n.pitch
        rt = _tuples(ref_d, dkey)
        et = _tuples(est_d, dkey)
        m = _match_count(rt, et, onset_tolerance, with_offset=False)
        _, _, s.drum_f1 = precision_recall_f1(m, len(rt), len(et))
    return s


class AMTMetrics:
    """Macro-averaging accumulator over tracks (reference `AMTMetrics`)."""

    def __init__(self, eval_program_vocab: Optional[InstrumentVocabulary] = None,
                 eval_drum_vocab: Optional[DrumVocabulary] = None):
        self.eval_program_vocab = eval_program_vocab
        self.eval_drum_vocab = eval_drum_vocab
        self._tracks: List[TrackScores] = []

    def update(self, ref_notes: Sequence[Note], est_notes: Sequence[Note]) -> TrackScores:
        s = evaluate_track(ref_notes, est_notes,
                           self.eval_program_vocab, self.eval_drum_vocab)
        self._tracks.append(s)
        return s

    def compute(self) -> Dict[str, float]:
        """Macro-average each metric over the tracks where it was actually
        evaluated (None = undefined on that track, e.g. drum_f1 with no
        drums anywhere); metrics defined on zero tracks are omitted."""
        if not self._tracks:
            return {}
        out: Dict[str, float] = {}
        for f in dataclasses.fields(TrackScores):
            if f.name == "class_counts":
                continue
            vals = [getattr(t, f.name) for t in self._tracks]
            vals = [v for v in vals if v is not None]
            if vals:
                out[f.name] = float(np.mean(vals))
        return out

    def compute_per_class(self) -> Dict[str, Dict[str, float]]:
        """Per-instrument-class onset P/R/F1, micro-aggregated across
        tracks (raw match/ref/est counts summed, then one P/R/F1 per
        class — stable for classes that are rare on any single track).
        {} when no eval_program_vocab was set."""
        agg: Dict[str, List[int]] = {}
        for t in self._tracks:
            for name, (m, nr, ne) in (t.class_counts or {}).items():
                a = agg.setdefault(name, [0, 0, 0])
                a[0] += m
                a[1] += nr
                a[2] += ne
        out: Dict[str, Dict[str, float]] = {}
        for name, (m, nr, ne) in agg.items():
            p, r, f = precision_recall_f1(m, nr, ne)
            out[name] = {"precision": round(p, 4), "recall": round(r, 4),
                         "f1": round(f, 4), "n_ref": nr, "n_est": ne}
        return out

    @property
    def num_tracks(self) -> int:
        return len(self._tracks)


def offset_error_stats(ref_notes: Sequence[Note],
                       est_notes: Sequence[Note],
                       onset_tol: float = ONSET_TOL) -> Dict[str, float]:
    """Signed-offset-error diagnostics over onset+pitch-matched note pairs.

    Offset F1 has trailed onset F1 in every round (0.40–0.45 on the
    flagship). This separates the two candidate causes: a SYSTEMATIC
    detok/model bias (|mean| signed error ≫ 0 — e.g. offsets consistently
    early because release tails are under-modeled) vs symmetric noise
    (mean ≈ 0, wide spread — an observability/capacity limit). Pairs are
    matched greedily nearest-onset within the onset tolerance, same pitch
    and drum flag; drums are excluded (their offsets are nominal).
    """
    ref_p = [n for n in ref_notes if not n.is_drum]
    est_p = [n for n in est_notes if not n.is_drum]
    errors: List[float] = []
    used: set = set()
    by_pitch: Dict[int, List[Tuple[int, Note]]] = {}
    for j, e in enumerate(est_p):
        by_pitch.setdefault(e.pitch, []).append((j, e))
    for r in ref_p:
        cands = [(abs(r.onset - e.onset), j, e)
                 for j, e in by_pitch.get(r.pitch, ())
                 if j not in used and abs(r.onset - e.onset) <= onset_tol]
        if not cands:
            continue
        _, j, e = min(cands, key=lambda c: c[0])
        used.add(j)
        errors.append(e.offset - r.offset)
    if not errors:
        return {"n_pairs": 0.0}
    a = np.asarray(errors)
    tol = OFFSET_MIN_TOL  # short-note floor; per-note ratio tol not applied
    return {
        "n_pairs": float(len(a)),
        "mean_signed_s": float(a.mean()),
        "median_signed_s": float(np.median(a)),
        "std_s": float(a.std()),
        "p_early": float((a < -tol).mean()),   # est offset too early
        "p_late": float((a > tol).mean()),     # est offset too late
        "p_within_tol": float((np.abs(a) <= tol).mean()),
        # raw signed errors: callers that aggregate across tracks must pool
        # these (a mean of per-track medians/stds is NOT the pooled
        # median/std — ADVICE r4); stripped before any JSON dump.
        "raw_errors_s": [float(x) for x in errors],
    }
