"""The three IRs of the token domain: Note, NoteEvent, Event.

Capability parity target: reference `utils/note_event_dataclasses.py`
(SURVEY.md C5).

- ``Note``: a complete note with onset/offset in seconds.
- ``NoteEvent``: a point event (onset if velocity > 0, offset if 0); the
  intermediate between notes and the serialized MT3 event stream.
- ``Event``: one token-domain symbol, ``(type, value)``.

All times are float seconds; quantization to 10 ms codec ticks happens only
at event-serialization time (note2event.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Set, Tuple


@dataclasses.dataclass(order=True)
class Note:
    is_drum: bool
    program: int  # 0..127, or 128 (DRUM_PROGRAM) for drums
    onset: float  # seconds
    offset: float  # seconds
    pitch: int  # 0..127 (drum note number for drums)
    velocity: int  # 1..127 (or 1 when binarized)

    def __post_init__(self) -> None:
        if self.offset < self.onset:
            self.offset = self.onset


@dataclasses.dataclass
class NoteEvent:
    is_drum: bool
    program: int
    time: Optional[float]  # seconds; None for tie-section declaration events
    velocity: int  # 0 = offset, >0 = onset
    pitch: int
    activity: Optional[Set[int]] = None  # indices of notes sounding at this time

    @property
    def is_onset(self) -> bool:
        return self.velocity > 0

    def position_key(self) -> Tuple[int, int, int, int]:
        """Deterministic intra-tick ordering: offsets first, then by program,
        pitched before drums, then pitch. This fixes the serialization order
        for simultaneous events (the reference sorts equivalently in
        `utils/note2event.py`)."""
        return (
            1 if self.velocity > 0 else 0,
            self.program,
            1 if self.is_drum else 0,
            self.pitch,
        )


@dataclasses.dataclass(frozen=True)
class Event:
    type: str  # 'shift'|'pitch'|'velocity'|'tie'|'program'|'drum'|'sos'|'eos'|'pad'|'unk'|task names
    value: int = 0


# Convenience constructors -------------------------------------------------

def onset_event(program: int, pitch: int, time: float, velocity: int = 1,
                is_drum: bool = False) -> NoteEvent:
    return NoteEvent(is_drum=is_drum, program=program, time=time,
                     velocity=velocity, pitch=pitch)


def offset_event(program: int, pitch: int, time: float,
                 is_drum: bool = False) -> NoteEvent:
    return NoteEvent(is_drum=is_drum, program=program, time=time,
                     velocity=0, pitch=pitch)


def sort_notes(notes: List[Note]) -> List[Note]:
    return sorted(notes, key=lambda n: (n.onset, n.is_drum, n.program, n.pitch, n.offset))
