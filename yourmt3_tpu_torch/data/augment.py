"""Stem-submix augmentation (host-side, numpy).

Capability parity target: reference `utils/augment.py` (SURVEY.md C13):
intra-track stem submix and CROSS-dataset stem submix — random subsets of
stems summed into synthetic mixtures (the key YourMT3+ data trick for
Slakh), random per-stem gain, channel drop.

Runs in the host data pipeline on raw audio crops; the on-device augments
(spec-augment, pitch shift) live in ops/specaugment.py and ops/pitchshift.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..tokens.dataclasses import Note
from ..tokens.note2event import mix_notes


def audio_random_submix(
    stems_audio: Sequence[np.ndarray],  # each (L,)
    stems_notes: Sequence[Sequence[Note]],
    rng: np.random.Generator,
    p_include: float = 0.8,
    gain_range: Tuple[float, float] = (0.5, 1.2),
    normalize: bool = True,
) -> Tuple[np.ndarray, List[Note]]:
    """Random subset of stems → (mix_audio, mix_notes). At least one stem
    is always kept (reference `audio_random_submix_fn`)."""
    n = len(stems_audio)
    keep = rng.random(n) < p_include
    if not keep.any():
        keep[int(rng.integers(0, n))] = True
    gains = rng.uniform(*gain_range, size=n)
    L = max(len(a) for a in stems_audio)
    mix = np.zeros(L, np.float32)
    notes: List[List[Note]] = []
    for i, (a, nt) in enumerate(zip(stems_audio, stems_notes)):
        if not keep[i]:
            continue
        mix[: len(a)] += gains[i] * a
        notes.append(list(nt))
    if normalize:
        peak = np.abs(mix).max()
        if peak > 1.0:
            mix /= peak
    return mix, mix_notes(notes)


def cross_track_submix(
    track_a: Tuple[Sequence[np.ndarray], Sequence[Sequence[Note]]],
    track_b: Tuple[Sequence[np.ndarray], Sequence[Sequence[Note]]],
    rng: np.random.Generator,
    p_include: float = 0.5,
) -> Tuple[np.ndarray, List[Note]]:
    """Cross-dataset submix: pool stems of two different tracks and submix
    (reference cross-dataset stem augmentation)."""
    audio = list(track_a[0]) + list(track_b[0])
    notes = list(track_a[1]) + list(track_b[1])
    return audio_random_submix(audio, notes, rng, p_include)


def random_gain(audio: np.ndarray, rng: np.random.Generator,
                db_range: Tuple[float, float] = (-6.0, 3.0)) -> np.ndarray:
    g = 10.0 ** (rng.uniform(*db_range) / 20.0)
    out = audio * g
    peak = np.abs(out).max()
    return out / peak if peak > 1.0 else out
