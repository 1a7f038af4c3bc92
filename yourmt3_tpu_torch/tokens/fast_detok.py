"""Vectorized detokenization: the tensor front half and the numpy merge.

The stateful parts of MT3 detokenization factor into
1. id → (type, value): a table gather;
2. time: the running max of shift values (`torch.cummax`);
3. program and velocity: a forward fill of state events (the running max
   of the last position that set them, then a gather);
4. the tie section: positions before the first `tie` token;
5. onset/offset pairing and the cross-segment merge, on the host with
   numpy (it touches about ten times fewer items than there are tokens).

`_extract` runs 1-4 over a whole (S, C, L) batch as plain tensor code on
the device of the ids it is given; `FastDetokenizer.detokenize_song` does
5 with the semantics of tokens/event2note.py's merge. Its error counts
are those of the reference package's fast path, which differ from the
Python walk's `dropped_events` on streams with non-declaration events
before their `tie` token or with no `tie` token at all (the walk counts
them, this path does not).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .codec import EventCodec
from .dataclasses import Note
from .event2note import DRUM_OFFSET_TIME, DecodeErrors


def _forward_fill(is_set: torch.Tensor, values: torch.Tensor,
                  init) -> torch.Tensor:
    """Per row: y[i] = values[j] for the last j ≤ i with is_set[j], else
    init (scalar, or (N, 1) tensor for per-row defaults). A running max
    over set positions, then a gather."""
    L = is_set.shape[-1]
    idx = torch.arange(L, device=is_set.device)[None, :]
    pos = torch.where(is_set, idx, -1)
    last = torch.cummax(pos, dim=-1).values
    filled = torch.gather(values, -1, torch.clamp(last, min=0))
    return torch.where(last >= 0, filled, init)


def _extract(ids: torch.Tensor, id_to_type: torch.Tensor,
             id_to_value: torch.Tensor, type_ids: tuple,
             init_prog: torch.Tensor) -> Dict[str, torch.Tensor]:
    (T_PAD, T_EOS, T_SHIFT, T_PITCH, T_VEL, T_TIE, T_PROG, T_DRUM) = type_ids
    V = id_to_type.shape[0]
    flat = ids.reshape(-1, ids.shape[-1])  # (N, L)
    ok = (flat >= 0) & (flat < V)
    safe = torch.where(ok, flat, 0).long()
    t = torch.where(ok, id_to_type[safe], -1)
    v = torch.where(ok, id_to_value[safe], 0)
    L = flat.shape[-1]
    idx = torch.arange(L, device=flat.device)[None, :]

    # stream ends at first EOS
    is_eos = t == T_EOS
    eos_pos = torch.amin(torch.where(is_eos, idx, L), dim=-1, keepdim=True)
    live = idx < eos_pos

    # tie section: strictly before the first tie token
    is_tie = (t == T_TIE) & live
    tie_pos = torch.amin(torch.where(is_tie, idx, L), dim=-1, keepdim=True)
    in_tie = (idx < tie_pos) & live
    in_stream = (idx > tie_pos) & live  # after the tie marker

    # time: running max of shift values within the stream (-1 until the
    # first shift); a shift below the running max is nonmonotonic (the
    # walk counts and skips it; the running max skips it too)
    is_shift = (t == T_SHIFT) & in_stream
    shift_val = torch.where(is_shift, v, -1)
    tick = torch.cummax(shift_val, dim=-1).values
    prev_tick = torch.cat([torch.full_like(tick[:, :1], -1), tick[:, :-1]],
                          dim=-1)
    nonmono = is_shift & (v < prev_tick)

    # init_prog: (N, 1) per-row program default, a multi-channel task's
    # channel-canonical program (see event2note.NoteDecodingState)
    program = _forward_fill((t == T_PROG) & in_stream, v, init_prog)
    vel = _forward_fill((t == T_VEL) & in_stream, v, 1)

    is_pitch = (t == T_PITCH) & in_stream
    is_drum = (t == T_DRUM) & in_stream
    tie_prog = _forward_fill((t == T_PROG) & in_tie, v, init_prog)
    is_tie_pitch = (t == T_PITCH) & in_tie

    return {
        "tick": tick, "program": program, "velocity": vel,
        "is_pitch": is_pitch, "is_drum_hit": is_drum, "value": v,
        "tie_program": tie_prog, "is_tie_pitch": is_tie_pitch,
        "nonmono": nonmono,
        "raw_type": t,
    }


def _as_tensor(ids: Union[torch.Tensor, np.ndarray]) -> torch.Tensor:
    if isinstance(ids, torch.Tensor):
        return ids
    return torch.from_numpy(np.ascontiguousarray(ids))


class FastDetokenizer:
    """Batched (S, C, L) ids → merged notes; the front half runs on the
    ids' device."""

    def __init__(self, codec: Optional[EventCodec] = None):
        self.codec = codec or EventCodec()
        tbl = self.codec.decode_tables()
        self._id_to_type = torch.from_numpy(tbl["id_to_type"])
        self._id_to_value = torch.from_numpy(tbl["id_to_value"])
        ti = self.codec.type_index
        self._type_ids = (ti["pad"], ti["eos"], ti["shift"], ti["pitch"],
                          ti["velocity"], ti["tie"], ti["program"], ti["drum"])

    def extract(self, ids: Union[torch.Tensor, np.ndarray],
                row_default_programs: Optional[np.ndarray] = None
                ) -> Dict[str, np.ndarray]:
        """(…, L) ids → {key: (N, L) numpy array}, rows flattened (s·C + c)."""
        ids = _as_tensor(ids)
        dev = ids.device
        L = ids.shape[-1]
        flat = ids.reshape(-1, L)
        n = flat.shape[0]
        if row_default_programs is None:
            init = torch.zeros((n, 1), dtype=torch.int32, device=dev)
        else:
            init = torch.as_tensor(np.asarray(row_default_programs, np.int32)
                                   ).to(dev)[:, None]
        out = _extract(flat, self._id_to_type.to(dev),
                       self._id_to_value.to(dev), self._type_ids, init)
        return {k: v.cpu().numpy() for k, v in out.items()}

    # ------------------------------------------------------------------
    def detokenize_song(self, segment_ids: Union[torch.Tensor, np.ndarray],
                        start_times: Sequence[float],
                        default_programs: Optional[Sequence[int]] = None
                        ) -> Tuple[List[Note], DecodeErrors]:
        """(S, C, L) → notes; same semantics as TaskManager.detokenize_song.

        Channels are independent streams; each channel's segments merge
        through one _FastMergeState fed with the extracted arrays.
        ``default_programs[c]`` seeds channel c's program state (see
        event2note.NoteDecodingState).
        """
        segment_ids = _as_tensor(segment_ids)
        if segment_ids.ndim == 2:
            segment_ids = segment_ids[:, None, :]
        S, C, L = segment_ids.shape
        row_defaults = None
        if default_programs is not None:
            row_defaults = np.tile(
                np.asarray(default_programs, np.int32), S)  # rows = s*C + c
        ex = self.extract(segment_ids, row_defaults)  # rows are (s*C + c)
        codec = self.codec
        sps = codec.steps_per_second
        all_notes: List[Note] = []
        errors = DecodeErrors()
        order = np.argsort(np.asarray(start_times))
        for c in range(C):
            state = _FastMergeState(codec)
            for s in order:
                r = s * C + c
                t0 = float(start_times[s])
                ties = [(int(p), int(v)) for p, v in zip(
                    ex["tie_program"][r][ex["is_tie_pitch"][r]],
                    ex["value"][r][ex["is_tie_pitch"][r]])]
                events, n_dropped = _segment_event_rows(ex, r, t0, sps)
                errors.dropped_events += n_dropped
                errors.nonmonotonic_shifts += int(ex["nonmono"][r].sum())
                state.process(ties, events, t0)
            notes, err = state.finish()
            all_notes.extend(notes)
            errors.add(err)
        all_notes.sort(key=lambda n: (n.onset, n.is_drum, n.program, n.pitch))
        return all_notes, errors


def _segment_event_rows(ex, r: int, t0: float, steps_per_second: int):
    """→ (rows, n_dropped_drums): structured rows (time, kind, program,
    pitch, velocity) for the pitch/drum events of row r. kind: 0 offset,
    1 onset, 2 drum. Drum tokens seen while the forward-filled velocity
    state is 0 are dropped (and counted), as the walk's drum branch does."""
    sel = ex["is_pitch"][r] | ex["is_drum_hit"][r]
    vel_all = ex["velocity"][r]
    dead_drum = ex["is_drum_hit"][r] & (vel_all <= 0)
    n_dropped = int(dead_drum.sum())
    sel = sel & ~dead_drum
    if not sel.any():
        return [], n_dropped
    tick = ex["tick"][r][sel]
    prog = ex["program"][r][sel]
    vel = vel_all[sel]
    val = ex["value"][r][sel]
    drum = ex["is_drum_hit"][r][sel]
    time = t0 + np.maximum(tick, 0) / steps_per_second
    kind = np.where(drum, 2, (vel > 0).astype(np.int64))
    return list(zip(time.tolist(), kind.tolist(), prog.tolist(),
                    val.tolist(), vel.tolist())), n_dropped


class _FastMergeState:
    """Note pairing + tie merge over extracted rows (the walk's
    NoteDecodingState semantics at the note level)."""

    def __init__(self, codec: EventCodec):
        self.codec = codec
        self.active: Dict[Tuple[int, int], Tuple[float, int]] = {}
        self.notes: List[Note] = []
        self.err = DecodeErrors()
        self.last_time = 0.0

    def process(self, ties, events, t0: float) -> None:
        declared = set(ties)
        for key in list(self.active):
            if key not in declared:
                self._close(key, t0)
        for key in declared:
            if key not in self.active:
                self.err.tie_without_active_note += 1
                self.active[key] = (t0, 100)
        for time, kind, prog, pitch, vel in events:
            if kind == 2:  # drum (vel > 0 guaranteed: dead drums dropped)
                self.notes.append(Note(True, 128, time,
                                       time + DRUM_OFFSET_TIME, pitch,
                                       self.codec.bin_to_velocity(vel)))
            elif kind == 1:  # onset
                key = (prog, pitch)
                if key in self.active:
                    self._close(key, time)
                self.active[key] = (time, self.codec.bin_to_velocity(vel))
            else:  # offset
                key = (prog, pitch)
                if key in self.active:
                    self._close(key, time)
                else:
                    self.err.unmatched_offsets += 1
        self.last_time = max(self.last_time, t0 + self.codec.segment_seconds)

    def _close(self, key, time: float) -> None:
        onset, vel = self.active.pop(key)
        self.notes.append(Note(False, key[0], onset, max(time, onset),
                               key[1], vel))

    def finish(self):
        for key in list(self.active):
            self._close(key, self.last_time)
        self.notes.sort(key=lambda n: (n.onset, n.is_drum, n.program, n.pitch))
        return self.notes, self.err
