"""TaskManager: the single point binding task config → codec/tokenizers.

Capability parity target: reference `utils/task_manager.py` (SURVEY.md C11):
computes `num_decoding_channels`, task-token conditioning ids, per-channel
vocab/tokenizers; consulted by both the data pipeline and the model.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config.audio import AudioConfig, DEFAULT_AUDIO
from ..config.task import TaskConfig, get_task
from ..config.vocabulary import DRUM_PROGRAM
from ..utils import profiling
from .codec import EventCodec
from .dataclasses import Note
from .event2note import (DecodeErrors, merge_multi_channel_token_ids_to_notes,
                         merge_segment_token_ids_to_notes)
from .tokenizer import NoteEventTokenizer


class TaskManager:
    def __init__(self, task: Union[str, TaskConfig] = "mt3_full_plus",
                 audio_cfg: AudioConfig = DEFAULT_AUDIO):
        self.task = get_task(task) if isinstance(task, str) else task
        self.audio_cfg = audio_cfg
        self.codec = EventCodec(
            steps_per_second=100,
            segment_seconds=audio_cfg.segment_seconds,
            num_velocity_bins=self.task.num_velocity_bins,
            extra_tokens=self.task.subtask_tokens,
        )
        self.tokenizer = NoteEventTokenizer(
            self.codec, max_length=self.task.effective_max_length)
        self._prog_to_class = self.task.program_vocab.program_to_class_array()
        self._prog_to_canonical = self.task.program_vocab.program_to_canonical_array()
        self._drum_to_canonical = self.task.drum_vocab.note_to_canonical_array()
        self._fast_detok = None  # built on first use

    # ---- sizes the model needs -----------------------------------------
    @property
    def num_decoding_channels(self) -> int:
        return self.task.num_decoding_channels

    @property
    def vocab_size(self) -> int:
        return self.codec.vocab_size

    @property
    def max_token_length(self) -> int:
        return self.task.effective_max_length

    @property
    def channel_default_programs(self) -> List[int]:
        """Per-channel program state before the first `program` token.

        Multi-channel tasks bind channel c to instrument class c, so a
        degenerate stream that dropped its program token should default to
        the CHANNEL's canonical program — defaulting to GM 0 spilled every
        such stream into the piano class (flagship piano precision 0.102,
        VERDICT r4). The drum channel (last, if present) keeps 0: pitched
        events there are decode anomalies either way. Healthy streams are
        unaffected (serialization always emits a program token before the
        first pitched event — note2event.note_event2event)."""
        C = self.num_decoding_channels
        if C == 1:
            return [0]
        out = [cls.canonical_program for cls in self.task.program_vocab.classes]
        while len(out) < C:
            out.append(0)
        return out[:C]

    def subtask_prefix_ids(self, subtask: Optional[str] = None) -> List[int]:
        name = subtask or self.task.default_subtask
        if name is None:
            return []
        from .dataclasses import Event
        return [self.codec.encode_event(Event(name, 0))]

    # ---- note remapping -------------------------------------------------
    def remap_notes(self, notes: Sequence[Note]) -> List[Note]:
        """Map programs/drum-notes to their vocabulary canonicals; drop
        unmapped notes (reference behavior for out-of-vocab programs)."""
        out: List[Note] = []
        for n in notes:
            if n.is_drum:
                c = int(self._drum_to_canonical[n.pitch]) if 0 <= n.pitch < 128 else -1
                if c < 0:
                    continue
                out.append(Note(True, DRUM_PROGRAM, n.onset, n.offset, c, n.velocity))
            else:
                if self.task.canonicalize_programs:
                    p = int(self._prog_to_canonical[n.program]) if 0 <= n.program <= 128 else -1
                    if p < 0:
                        continue
                else:
                    p = n.program
                    if not 0 <= p < 128:
                        continue
                out.append(Note(False, p, n.onset, n.offset, n.pitch, n.velocity))
        return out

    def channel_of(self, note: Note) -> int:
        """Decoding channel index for a note (multi-channel tasks)."""
        p = DRUM_PROGRAM if note.is_drum else note.program
        return int(self._prog_to_class[p])

    # ---- tokenize -------------------------------------------------------
    def tokenize_segment(self, notes: Sequence[Note], start_time: float,
                         subtask: Optional[str] = None,
                         remap: bool = True) -> np.ndarray:
        """Full-song notes + segment start → (C, L) int32 token ids.

        C == num_decoding_channels (1 for single-stream tasks). Channel c
        serializes only the notes whose instrument class maps to c.
        """
        if remap:
            notes = self.remap_notes(notes)
        prefix = self.subtask_prefix_ids(subtask)
        C = self.num_decoding_channels
        if C == 1:
            return self.tokenizer.encode_notes_segment(
                notes, start_time, prefix_ids=prefix)[None, :]
        per_ch: List[List[Note]] = [[] for _ in range(C)]
        for n in notes:
            c = self.channel_of(n)
            if 0 <= c < C:
                per_ch[c].append(n)
        rows = [self.tokenizer.encode_notes_segment(ch_notes, start_time,
                                                    prefix_ids=prefix)
                for ch_notes in per_ch]
        return np.stack(rows, axis=0)

    def tokenize_song(self, notes: Sequence[Note], start_times: Sequence[float],
                      subtask: Optional[str] = None) -> np.ndarray:
        """(S, C, L) labels for all segments of a song."""
        notes = self.remap_notes(notes)
        return np.stack([self.tokenize_segment(notes, t, subtask, remap=False)
                         for t in start_times], axis=0)

    # ---- detokenize -----------------------------------------------------
    def detokenize_song(self, segment_ids: Union[np.ndarray, torch.Tensor],
                        start_times: Sequence[float],
                        fast: bool = True
                        ) -> Tuple[List[Note], DecodeErrors]:
        """(S, C, L) predicted ids → merged full-song notes.

        fast=True runs the vectorized extraction front half
        (tokens/fast_detok.py) on the device of the ids it is given, as the
        reference package's default does; fast=False walks the tokens in
        Python. Their error counts can differ: the walk counts events
        before or without a `tie` token as dropped (see
        tokens/fast_detok.py).
        """
        with profiling.span("detokenize"):
            if fast:
                if self._fast_detok is None:
                    from .fast_detok import FastDetokenizer
                    self._fast_detok = FastDetokenizer(self.codec)
                return self._fast_detok.detokenize_song(
                    segment_ids, start_times,
                    default_programs=self.channel_default_programs)
            if isinstance(segment_ids, torch.Tensor):
                segment_ids = segment_ids.cpu().numpy()
            segment_ids = np.asarray(segment_ids)
            if segment_ids.ndim == 2:
                segment_ids = segment_ids[:, None, :]
            defaults = self.channel_default_programs
            S, C, _ = segment_ids.shape
            if C == 1:
                return merge_segment_token_ids_to_notes(
                    [segment_ids[s, 0] for s in range(S)], list(start_times),
                    self.codec, default_program=defaults[0])
            return merge_multi_channel_token_ids_to_notes(
                [[segment_ids[s, c] for s in range(S)] for c in range(C)],
                list(start_times), self.codec, default_programs=defaults)
