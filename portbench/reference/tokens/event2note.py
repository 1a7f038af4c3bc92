"""Event stream → notes: the detokenization state machine + segment merge.

Capability parity target: reference `utils/event2note.py` (SURVEY.md C7):
`event2note_event` (shift-monotonicity validation, program/velocity state,
tie section), `note_event2note` (onset/offset pairing, unmatched-offset
handling), `merge_zipped_note_events_and_ties_to_notes` (cross-segment
merge). Error counts are returned, never raised — decode output from a
model is untrusted.

Design difference from the reference (intentional): segments are merged
through a single persistent ``NoteDecodingState`` walked segment-by-segment
instead of zip-then-merge — same observable behavior (tie continuation,
close-at-boundary for undeclared actives), simpler state.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .codec import EventCodec
from .dataclasses import Event, Note

DRUM_OFFSET_TIME = 0.01  # drums are points; fixed tiny duration on decode


@dataclasses.dataclass
class DecodeErrors:
    invalid_events: int = 0
    dropped_events: int = 0  # events before tie marker end / malformed
    unmatched_offsets: int = 0
    nonmonotonic_shifts: int = 0
    tie_without_active_note: int = 0

    def total(self) -> int:
        return (self.invalid_events + self.dropped_events + self.unmatched_offsets
                + self.nonmonotonic_shifts + self.tie_without_active_note)

    def add(self, other: "DecodeErrors") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))


@dataclasses.dataclass
class _ActiveNote:
    onset: float
    velocity: int
    program: int
    pitch: int


class NoteDecodingState:
    """Persistent decoding state across a song's segment sequence."""

    _STANDARD_TYPES = {"pad", "eos", "unk", "shift", "pitch", "velocity",
                       "tie", "program", "drum"}

    def __init__(self, codec: Optional[EventCodec] = None,
                 default_program: int = 0):
        self.codec = codec or EventCodec()
        # task-conditioning tokens are prefix no-ops during decoding
        self.task_types = set(self.codec.type_names) - self._STANDARD_TYPES
        self.active: Dict[Tuple[int, int], _ActiveNote] = {}  # (program,pitch) → note
        self.notes: List[Note] = []
        self.errors = DecodeErrors()
        self.last_time = 0.0
        # Program state before the stream's first `program` token. Healthy
        # streams always carry one before the first pitched event
        # (note2event serializes from cur_program=None), so this only
        # matters for DEGENERATE decodes that dropped it — and for a
        # multi-channel task the channel's canonical program is strictly
        # more correct than GM 0 (piano): defaulting to 0 silently spilled
        # every program-less stream into the piano class (flagship piano
        # precision 0.102, n_est 441 vs n_ref 92, VERDICT r4 weak-2).
        self.default_program = default_program

    # ------------------------------------------------------------------
    def process_segment(self, events: Sequence[Event], start_time: float) -> None:
        """Consume one segment's decoded Event stream (tie section + stream)."""
        seg_len = self.codec.segment_seconds
        idx = 0
        declared: set = set()
        cur_program = self.default_program

        # ---- tie section: [program?] pitch* ... 'tie' ----
        saw_tie = False
        while idx < len(events):
            e = events[idx]
            if e.type == "tie":
                idx += 1
                saw_tie = True
                break
            elif e.type == "program":
                cur_program = e.value
            elif e.type == "pitch":
                declared.add((cur_program, e.value))
            elif e.type in ("eos", "pad"):
                idx += 1
                saw_tie = True  # empty/odd segment; treat as empty tie section
                break
            elif e.type in self.task_types:
                pass  # conditioning prefix, no semantic content
            else:
                self.errors.dropped_events += 1
            idx += 1
        if not saw_tie:
            # stream had no tie marker at all: everything was tie-like decl.
            self.errors.dropped_events += max(0, len(events) - idx)

        # ---- reconcile actives with declared ties ----
        for key in list(self.active.keys()):
            if key not in declared:
                self._close(key, start_time)
        for key in declared:
            if key not in self.active:
                # tie declared but we never saw its onset (e.g. first segment
                # decoded mid-song): start it at the segment boundary.
                self.errors.tie_without_active_note += 1
                self.active[key] = _ActiveNote(onset=start_time, velocity=100,
                                               program=key[0], pitch=key[1])

        # ---- event stream ----
        cur_program = self.default_program
        cur_velocity = self.codec.bin_to_velocity(1)
        cur_is_onset = True
        cur_time = start_time
        max_step_seen = -1
        for e in events[idx:]:
            if e.type == "shift":
                if e.value < max_step_seen:
                    self.errors.nonmonotonic_shifts += 1
                    continue
                max_step_seen = e.value
                cur_time = start_time + self.codec.step_to_time(e.value)
            elif e.type == "program":
                cur_program = e.value
            elif e.type == "velocity":
                cur_is_onset = e.value > 0
                if e.value > 0:
                    cur_velocity = self.codec.bin_to_velocity(e.value)
            elif e.type == "pitch":
                key = (cur_program, e.value)
                if cur_is_onset:
                    if key in self.active:
                        self._close(key, cur_time)  # re-articulation
                    self.active[key] = _ActiveNote(cur_time, cur_velocity,
                                                   cur_program, e.value)
                else:
                    if key in self.active:
                        self._close(key, cur_time)
                    else:
                        self.errors.unmatched_offsets += 1
            elif e.type == "drum":
                if cur_is_onset:
                    self.notes.append(Note(True, 128, cur_time,
                                           cur_time + DRUM_OFFSET_TIME,
                                           e.value, cur_velocity))
                else:
                    self.errors.dropped_events += 1
            elif e.type in ("eos", "pad"):
                break
            elif e.type == "unk":
                self.errors.invalid_events += 1
            elif e.type in self.task_types:
                pass
            else:
                self.errors.dropped_events += 1
        self.last_time = max(self.last_time, start_time + seg_len)

    # ------------------------------------------------------------------
    def _close(self, key: Tuple[int, int], time: float) -> None:
        a = self.active.pop(key)
        self.notes.append(Note(False, a.program, a.onset, max(time, a.onset),
                               a.pitch, a.velocity))

    def finish(self, end_time: Optional[float] = None) -> List[Note]:
        """Close remaining actives and return time-sorted notes."""
        t = end_time if end_time is not None else self.last_time
        for key in list(self.active.keys()):
            self._close(key, t)
        self.notes.sort(key=lambda n: (n.onset, n.is_drum, n.program, n.pitch))
        return self.notes


# ---------------------------------------------------------------------------
# Functional wrappers matching the reference surface
# ---------------------------------------------------------------------------

def event2note_event(events: Sequence[Event], start_time: float = 0.0,
                     codec: Optional[EventCodec] = None
                     ) -> Tuple[List[Note], DecodeErrors]:
    """Decode ONE segment standalone (reference `event2note_event` +
    `note_event2note` fused). Notes still active at segment end are closed
    at segment end."""
    st = NoteDecodingState(codec)
    st.process_segment(events, start_time)
    notes = st.finish(start_time + st.codec.segment_seconds)
    return notes, st.errors


def ids_to_events(ids: np.ndarray, codec: EventCodec) -> List[Event]:
    """Token ids → Events, stopping at EOS, skipping PAD."""
    types, values = codec.classify_ids(np.asarray(ids))
    out: List[Event] = []
    names = codec.type_names
    for t, v in zip(types.tolist(), values.tolist()):
        name = names[t]
        if name == "eos":
            break
        if name == "pad":
            continue
        out.append(Event(name, v))
    return out


def merge_segment_token_ids_to_notes(
    segment_ids: Sequence[np.ndarray],
    start_times: Sequence[float],
    codec: Optional[EventCodec] = None,
    default_program: int = 0,
) -> Tuple[List[Note], DecodeErrors]:
    """Full-song decode: per-segment token ids (+ absolute start times) →
    merged note list with cross-segment tie continuation.

    This is the host-side tail of `transcribe()`; the per-id classification
    is vectorized, only the stateful walk is Python.
    """
    codec = codec or EventCodec()
    state = NoteDecodingState(codec, default_program=default_program)
    for ids, t0 in sorted(zip(segment_ids, start_times), key=lambda x: x[1]):
        state.process_segment(ids_to_events(ids, codec), t0)
    notes = state.finish()
    return notes, state.errors


def per_segment_error_counts(
    channel_segment_ids: Sequence[Sequence[np.ndarray]],
    start_times: Sequence[float],
    codec: Optional[EventCodec] = None,
    default_programs: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Attribute merge-walk decode errors to (channel, segment).

    Walks each channel's stream through the same persistent
    ``NoteDecodingState`` the real merge uses (same segment order) and
    snapshots ``errors.total()`` between segments. Returns two (C, S)
    int arrays: NEW errors charged to each segment, and the
    ``tie_without_active_note`` subset — a tie error at segment s usually
    means segment s-1's decode LOST the onset (degenerate stream), so
    repair passes should implicate both. Used by api.py's
    validate-and-repair decode (selective beam re-decode of only the
    segments the detokenizer flags)."""
    codec = codec or EventCodec()
    C, S = len(channel_segment_ids), len(start_times)
    totals = np.zeros((C, S), np.int64)
    ties = np.zeros((C, S), np.int64)
    order = sorted(range(S), key=lambda s: start_times[s])
    for c in range(C):
        st = NoteDecodingState(
            codec, default_program=(default_programs[c]
                                    if default_programs else 0))
        prev_tot, prev_tie = 0, 0
        for s in order:
            st.process_segment(
                ids_to_events(channel_segment_ids[c][s], codec),
                start_times[s])
            tot = st.errors.total()
            tie = st.errors.tie_without_active_note
            totals[c, s] = tot - prev_tot
            ties[c, s] = tie - prev_tie
            prev_tot, prev_tie = tot, tie
    return totals, ties


def merge_multi_channel_token_ids_to_notes(
    channel_segment_ids: Sequence[Sequence[np.ndarray]],
    start_times: Sequence[float],
    codec: Optional[EventCodec] = None,
    default_programs: Optional[Sequence[int]] = None,
) -> Tuple[List[Note], DecodeErrors]:
    """Multi-channel decode: ``channel_segment_ids[c][s]`` = ids for channel
    c, segment s. Channels are independent streams (each owns an instrument
    group) — decode each with its own state, then mix.

    ``default_programs[c]``: program state before channel c's first
    `program` token — pass the channel's class-canonical program so a
    degenerate stream that dropped its program token stays in its own
    class instead of spilling into piano (GM 0)."""
    codec = codec or EventCodec()
    all_notes: List[Note] = []
    errors = DecodeErrors()
    for c, per_seg in enumerate(channel_segment_ids):
        notes, err = merge_segment_token_ids_to_notes(
            per_seg, start_times, codec,
            default_program=(default_programs[c] if default_programs else 0))
        all_notes.extend(notes)
        errors.add(err)
    all_notes.sort(key=lambda n: (n.onset, n.is_drum, n.program, n.pitch))
    return all_notes, errors
