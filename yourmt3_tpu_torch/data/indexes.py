"""Dataset index contract: file lists + note storage.

Capability parity target: reference `data/yourmt3_indexes/
<ds>_{split}_file_list.json` + precomputed `{notes, note_events}` pickles
(SURVEY.md C16, §3.4). Differences (intentional): notes are stored as NPZ
arrays (columnar — mmap-friendly, no pickle), and the file list schema is
explicit JSON:

    {"tracks": [{"track_id": str,
                 "audio_file": str,          # wav path (16 kHz not required)
                 "notes_file": str,          # .npz via save_notes
                 "stem_files": {name: wav},  # optional, for submix aug
                 "stem_notes": {name: npz},  # optional
                 "program_list": [int,...],
                 "is_drum": bool|[bool,...],
                 "duration": float}],
     "dataset": str, "split": str}
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..tokens.dataclasses import Note


def save_notes(path: str, notes: Sequence[Note]) -> None:
    np.savez_compressed(
        path,
        is_drum=np.asarray([n.is_drum for n in notes], np.bool_),
        program=np.asarray([n.program for n in notes], np.int16),
        onset=np.asarray([n.onset for n in notes], np.float64),
        offset=np.asarray([n.offset for n in notes], np.float64),
        pitch=np.asarray([n.pitch for n in notes], np.int16),
        velocity=np.asarray([n.velocity for n in notes], np.int16),
    )


def load_notes(path: str) -> List[Note]:
    z = np.load(path)
    return [Note(bool(d), int(p), float(on), float(off), int(pi), int(v))
            for d, p, on, off, pi, v in zip(
                z["is_drum"], z["program"], z["onset"], z["offset"],
                z["pitch"], z["velocity"])]


def write_file_list(path: str, tracks: List[dict], dataset: str,
                    split: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump({"tracks": tracks, "dataset": dataset, "split": split}, f,
                  indent=1)


def load_file_list(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def index_path(data_home: str, dataset: str, split: str) -> str:
    return os.path.join(data_home, "yourmt3_indexes",
                        f"{dataset}_{split}_file_list.json")
