"""Event ↔ integer-id codec (vectorized).

Capability parity target: reference `utils/event_codec.py` `FastCodec`
(SURVEY.md C8). MT3-style vocabulary layout:

    0: PAD   1: EOS   2: UNK
    [3 .. 3+S]           shift 0..S      (10 ms ticks; shift/0 is unused)
    [.. +128]            pitch 0..127
    [.. +V+1]            velocity 0..V   (V velocity bins; 0 = note-off)
    [.. +1]              tie             (end-of-tie-section marker)
    [.. +128]            program 0..127
    [.. +128]            drum 0..127
    [tail]               task/special tokens (from the task registry)

Encode/decode are table-driven numpy ops so whole (B, L) id arrays can be
classified in one shot — this is what lets detokenization start on-device
(type/value splitting is a gather; only the final stateful merge is host
Python).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .dataclasses import Event

PAD_ID = 0
EOS_ID = 1
UNK_ID = 2
NUM_SPECIAL = 3


@dataclasses.dataclass(frozen=True)
class EventRange:
    type: str
    min_value: int
    max_value: int  # inclusive

    @property
    def size(self) -> int:
        return self.max_value - self.min_value + 1


class EventCodec:
    """Bidirectional Event ↔ int id mapping with O(1) numpy tables."""

    def __init__(
        self,
        steps_per_second: int = 100,
        segment_seconds: float = 32767 / 16000,
        num_velocity_bins: int = 1,
        extra_tokens: Sequence[str] = (),
    ):
        self.steps_per_second = steps_per_second
        self.segment_seconds = segment_seconds
        self.num_velocity_bins = num_velocity_bins
        self.max_shift_steps = int(math.ceil(segment_seconds * steps_per_second)) + 1

        self._ranges: List[EventRange] = [
            EventRange("shift", 0, self.max_shift_steps),
            EventRange("pitch", 0, 127),
            EventRange("velocity", 0, num_velocity_bins),
            EventRange("tie", 0, 0),
            EventRange("program", 0, 127),
            EventRange("drum", 0, 127),
        ]
        self._offsets: Dict[str, int] = {}
        off = NUM_SPECIAL
        for r in self._ranges:
            self._offsets[r.type] = off
            off += r.size
        self._extra_tokens: Dict[str, int] = {}
        for name in extra_tokens:
            self._extra_tokens[name] = off
            off += 1
        self._vocab_size = off

        # id → (type_index, value) decode tables
        type_names = ["pad", "eos", "unk"] + [r.type for r in self._ranges] + list(extra_tokens)
        self.type_names = type_names
        tid = np.zeros(self._vocab_size, dtype=np.int32)
        val = np.zeros(self._vocab_size, dtype=np.int32)
        tid[PAD_ID], tid[EOS_ID], tid[UNK_ID] = 0, 1, 2
        for i, r in enumerate(self._ranges):
            o = self._offsets[r.type]
            tid[o : o + r.size] = NUM_SPECIAL + i
            val[o : o + r.size] = np.arange(r.min_value, r.max_value + 1)
        for j, (name, idx) in enumerate(self._extra_tokens.items()):
            tid[idx] = NUM_SPECIAL + len(self._ranges) + j
        self._id_to_type = tid
        self._id_to_value = val
        self.type_index: Dict[str, int] = {n: i for i, n in enumerate(type_names)}

    # ---- sizes ----
    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def offset_of(self, event_type: str) -> int:
        return self._offsets[event_type]

    # ---- scalar paths ----
    def encode_event(self, event: Event) -> int:
        if event.type == "pad":
            return PAD_ID
        if event.type == "eos":
            return EOS_ID
        if event.type == "unk":
            return UNK_ID
        if event.type in self._extra_tokens:
            return self._extra_tokens[event.type]
        off = self._offsets.get(event.type)
        if off is None:
            raise ValueError(f"unknown event type {event.type!r}")
        r = next(x for x in self._ranges if x.type == event.type)
        if not (r.min_value <= event.value <= r.max_value):
            raise ValueError(f"{event.type} value {event.value} out of range "
                             f"[{r.min_value},{r.max_value}]")
        return off + (event.value - r.min_value)

    def decode_event_id(self, idx: int) -> Event:
        if idx < 0 or idx >= self._vocab_size:
            raise ValueError(f"id {idx} out of vocab")
        t = self.type_names[self._id_to_type[idx]]
        if t in ("pad", "eos", "unk") or t in self._extra_tokens:
            return Event(type=t, value=0)
        return Event(type=t, value=int(self._id_to_value[idx]))

    # ---- vectorized paths ----
    def encode_events(self, events: Sequence[Event]) -> np.ndarray:
        return np.asarray([self.encode_event(e) for e in events], dtype=np.int32)

    def classify_ids(self, ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(types, values) arrays; types index into ``self.type_names``.
        Out-of-vocab ids classify as UNK."""
        ids = np.asarray(ids)
        ok = (ids >= 0) & (ids < self._vocab_size)
        safe = np.where(ok, ids, UNK_ID)
        return (
            np.where(ok, self._id_to_type[safe], self.type_index["unk"]),
            np.where(ok, self._id_to_value[safe], 0),
        )

    # ---- velocity binning ----
    def velocity_to_bin(self, velocity: int) -> int:
        if velocity <= 0:
            return 0
        if self.num_velocity_bins == 1:
            return 1
        return int(math.ceil(self.num_velocity_bins * velocity / 127))

    def bin_to_velocity(self, bin_idx: int) -> int:
        if bin_idx <= 0:
            return 0
        if self.num_velocity_bins == 1:
            return 100  # MT3 convention: binarized onsets render at velocity 100
        return int(round(127 * bin_idx / self.num_velocity_bins))

    # ---- time quantization ----
    def time_to_step(self, t: float) -> int:
        return int(round(t * self.steps_per_second))

    def step_to_time(self, s: int) -> float:
        return s / self.steps_per_second

    # decode-table exports for on-device detokenization -----------------
    def decode_tables(self) -> Dict[str, np.ndarray]:
        """Dense id→(type,value) tables consumed by ops/detok kernels."""
        return {
            "id_to_type": self._id_to_type.copy(),
            "id_to_value": self._id_to_value.copy(),
        }
