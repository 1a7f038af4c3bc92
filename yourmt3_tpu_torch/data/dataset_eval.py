"""Eval dataset: whole files → sequential segments + reference notes.

Capability parity target: reference `utils/datasets_eval.py`
`AudioFileDataset` (SURVEY.md C15).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..config.audio import AudioConfig, DEFAULT_AUDIO
from ..tokens.dataclasses import Note
from .audio_io import load_audio_file, slice_padded_array
from .indexes import load_file_list, load_notes


class AudioFileDataset:
    def __init__(self, file_list: str, audio_cfg: AudioConfig = DEFAULT_AUDIO,
                 max_tracks: Optional[int] = None):
        self.ac = audio_cfg
        ds = load_file_list(file_list)
        self.tracks = ds["tracks"][:max_tracks] if max_tracks else ds["tracks"]
        self.dataset_name = ds.get("dataset", "?")

    def __len__(self) -> int:
        return len(self.tracks)

    def __getitem__(self, i: int) -> Tuple[str, np.ndarray, np.ndarray, List[Note]]:
        """→ (track_id, segments (S, input_frames), start_times (S,) sec,
        reference notes)."""
        t = self.tracks[i]
        audio, _ = load_audio_file(t["audio_file"], self.ac.sample_rate)
        segments, starts = slice_padded_array(audio, self.ac.input_frames)
        ref = load_notes(t["notes_file"])
        return (t.get("track_id", str(i)), segments,
                starts.astype(np.float64) / self.ac.sample_rate, ref)

    def __iter__(self) -> Iterator:
        for i in range(len(self)):
            yield self[i]
