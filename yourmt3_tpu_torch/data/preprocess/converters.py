"""Per-dataset converters: native annotations → unified index format.

Capability parity target: reference `utils/preprocess/preprocess_*.py` +
`install_dataset.py` (SURVEY.md C16, §3.4). Each converter walks a local
copy of the dataset, parses its native annotation format (MIDI / CSV /
TXT / JAMS-JSON / YAML), produces Note lists via the token domain, and
writes `{dataset}_{split}_file_list.json` + per-track notes NPZ.

Downloads (zenodo/gdrive in the reference) are out of scope offline; run
these against an already-downloaded tree:
    python -m yourmt3_tpu_torch.cli.install_dataset maestro --source /data/maestro-v3.0.0

Audio container note: our WAV reader handles .wav; datasets shipping
FLAC/MP3 (slakh, rwc) must be pre-converted (`ffmpeg -i x.flac x.wav`) —
the same step the reference performs at install time.
"""

from __future__ import annotations

import csv
import glob
import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ...config.vocabulary import DRUM_PROGRAM
from ...tokens.dataclasses import Note
from ...tokens.midi_io import midi2note
from ...tokens.note2event import mix_notes, validate_notes
from ..indexes import index_path, save_notes, write_file_list


def _emit(tracks: List[dict], data_home: str, dataset: str, split: str) -> str:
    out = index_path(data_home, dataset, split)
    write_file_list(out, tracks, dataset, split)
    print(f"[{dataset}/{split}] {len(tracks)} tracks → {out}")
    return out


def _notes_npz(data_home: str, dataset: str, track_id: str,
               notes: Sequence[Note]) -> str:
    d = os.path.join(data_home, "notes", dataset)
    os.makedirs(d, exist_ok=True)
    p = os.path.join(d, f"{track_id}.npz")
    save_notes(p, validate_notes(notes))
    return p


def _track(track_id: str, audio: str, notes_file: str, notes: Sequence[Note],
           **extra) -> dict:
    return {
        "track_id": track_id, "audio_file": audio, "notes_file": notes_file,
        "program_list": sorted({n.program for n in notes if not n.is_drum}),
        "is_drum": any(n.is_drum for n in notes), **extra,
    }


# ---------------------------------------------------------------------------

def preprocess_maestro(source: str, data_home: str) -> Dict[str, str]:
    """MAESTRO v3: maestro-v3.0.0.json metadata (columnar dict-of-dicts)."""
    meta_file = glob.glob(os.path.join(source, "maestro*.json"))[0]
    with open(meta_file) as f:
        meta = json.load(f)
    # v3 json: {"canonical_composer": {"0": ...}, "split": {"0": "train"}, ...}
    n = len(meta["split"])
    per_split: Dict[str, List[dict]] = {}
    for i in map(str, range(n)):
        split = {"train": "train", "validation": "validation",
                 "test": "test"}[meta["split"][i]]
        midi = os.path.join(source, meta["midi_filename"][i])
        audio = os.path.join(source, meta["audio_filename"][i])
        audio = os.path.splitext(audio)[0] + ".wav"
        notes = midi2note(midi, apply_sustain_pedal=True)
        tid = f"maestro_{i}"
        nf = _notes_npz(data_home, "maestro", tid, notes)
        per_split.setdefault(split, []).append(_track(tid, audio, nf, notes))
    return {s: _emit(t, data_home, "maestro", s) for s, t in per_split.items()}


def _find_audio(dirname: str, base: str) -> Optional[str]:
    """First existing of base.{wav,flac} — Slakh2100 ships FLAC (decoded
    by the first-party csrc/audio + data/flac.py decoders); resynthesized
    or converted trees may carry WAV."""
    for ext in (".wav", ".flac"):
        p = os.path.join(dirname, base + ext)
        if os.path.exists(p):
            return p
    return None


def preprocess_slakh(source: str, data_home: str) -> Dict[str, str]:
    """Slakh2100: {split}/TrackXXXXX/{mix.{wav,flac}, MIDI/SXX.mid,
    metadata.yaml}. Stem audio under stems/SXX.{wav,flac} enables submix
    augmentation."""
    out = {}
    for split_dir, split in (("train", "train"), ("validation", "validation"),
                             ("test", "test")):
        tracks = []
        for tdir in sorted(glob.glob(os.path.join(source, split_dir, "Track*"))):
            tid = "slakh_" + os.path.basename(tdir)
            mix = _find_audio(tdir, "mix")
            if mix is None:
                continue
            stem_meta = _parse_slakh_metadata(os.path.join(tdir, "metadata.yaml"))
            all_notes: List[List[Note]] = []
            stem_files, stem_notes = {}, {}
            for stem_id, info in stem_meta.items():
                mid = os.path.join(tdir, "MIDI", f"{stem_id}.mid")
                wav = _find_audio(os.path.join(tdir, "stems"), stem_id)
                if not os.path.exists(mid):
                    continue
                is_drum = bool(info.get("is_drum"))
                prog = int(info.get("program_num", 0))
                notes = midi2note(mid, force_all_drums=is_drum,
                                  force_program=None if is_drum else prog)
                all_notes.append(notes)
                if wav is not None:
                    nf = _notes_npz(data_home, "slakh", f"{tid}_{stem_id}", notes)
                    stem_files[stem_id] = wav
                    stem_notes[stem_id] = nf
            notes = mix_notes(all_notes)
            nf = _notes_npz(data_home, "slakh", tid, notes)
            tracks.append(_track(tid, mix, nf, notes, stem_files=stem_files,
                                 stem_notes=stem_notes))
        out[split] = _emit(tracks, data_home, "slakh", split)
    return out


def _parse_slakh_metadata(path: str) -> Dict[str, dict]:
    """Minimal YAML subset parser for slakh metadata (stems: SXX: keys)."""
    stems: Dict[str, dict] = {}
    if not os.path.exists(path):
        return stems
    cur: Optional[str] = None
    in_stems = False
    with open(path) as f:
        for line in f:
            raw = line.rstrip("\n")
            if not raw.strip() or raw.strip().startswith("#"):
                continue
            indent = len(raw) - len(raw.lstrip())
            s = raw.strip()
            if s == "stems:":
                in_stems = True
                continue
            if in_stems and indent == 2 and s.endswith(":"):
                cur = s[:-1]
                stems[cur] = {}
            elif in_stems and indent >= 4 and cur and ":" in s:
                k, v = s.split(":", 1)
                v = v.strip()
                if v.lower() in ("true", "false"):
                    stems[cur][k.strip()] = v.lower() == "true"
                else:
                    try:
                        stems[cur][k.strip()] = int(v)
                    except ValueError:
                        stems[cur][k.strip()] = v.strip("'\"")
            elif in_stems and indent == 0:
                in_stems = False
    return stems


def preprocess_guitarset(source: str, data_home: str) -> Dict[str, str]:
    """GuitarSet: annotation/*.jams (JSON) + audio_mono-mic/*_mic.wav.
    Splits: player-based (players 00-03 train, 04 val, 05 test)."""
    per_split: Dict[str, List[dict]] = {"train": [], "validation": [], "test": []}
    for jams in sorted(glob.glob(os.path.join(source, "annotation", "*.jams"))):
        base = os.path.splitext(os.path.basename(jams))[0]
        player = int(base.split("_")[0])
        split = "train" if player <= 3 else ("validation" if player == 4 else "test")
        audio = os.path.join(source, "audio_mono-mic", base + "_mic.wav")
        with open(jams) as f:
            j = json.load(f)
        notes: List[Note] = []
        for ann in j.get("annotations", []):
            if ann.get("namespace") != "note_midi":
                continue
            for obs in ann.get("data", []):
                pitch = int(round(obs["value"]))
                notes.append(Note(False, 24, obs["time"],
                                  obs["time"] + obs["duration"], pitch, 100))
        notes = mix_notes([notes])
        tid = f"guitarset_{base}"
        nf = _notes_npz(data_home, "guitarset", tid, notes)
        per_split[split].append(_track(tid, audio, nf, notes))
    return {s: _emit(t, data_home, "guitarset", s)
            for s, t in per_split.items() if t}


def _read_drum_txt(path: str, name_map: Dict[str, int]) -> List[Note]:
    """ENST-style 'time label' annotation lines → drum notes."""
    notes: List[Note] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            t = float(parts[0])
            pitch = name_map.get(parts[1].strip().lower())
            if pitch is not None:
                notes.append(Note(True, DRUM_PROGRAM, t, t + 0.01, pitch, 100))
    return notes


ENST_NAME_MAP = {
    "bd": 36, "sd": 38, "sweep": 38, "sticks": 38, "rs": 37, "cs": 37,
    "chh": 42, "ohh": 46, "phh": 44, "cb": 56, "c": 49, "lmt": 47,
    "mt": 47, "mtr": 47, "lt": 43, "ltr": 43, "lft": 41, "rc": 51,
    "ride": 51, "ch": 49, "cr": 49, "spl": 55, "cr1": 49, "cr5": 49,
    "c1": 49, "c4": 49, "sd-": 38, "cr2": 49, "rc2": 51, "rc4": 51,
    "rc3": 51,
}


def preprocess_enstdrums(source: str, data_home: str, wet_mix: str = "dtm"
                         ) -> Dict[str, str]:
    """ENST-Drums: drummer_N/audio/{wet_mix,dry_mix,...}/*.wav +
    annotation/*.txt. DTP = drums-only audio, DTM = with accompaniment.
    Split: drummer_1,2 train / drummer_3 test (standard protocol)."""
    dataset = f"enstdrums_{wet_mix}"
    audio_sub = {"dtp": "dry_mix", "dtm": "wet_mix"}.get(wet_mix, wet_mix)
    per_split: Dict[str, List[dict]] = {"train": [], "test": []}
    for drummer in sorted(glob.glob(os.path.join(source, "drummer_*"))):
        dnum = int(drummer.rsplit("_", 1)[1])
        split = "test" if dnum == 3 else "train"
        for ann in sorted(glob.glob(os.path.join(drummer, "annotation", "*.txt"))):
            base = os.path.splitext(os.path.basename(ann))[0]
            audio = os.path.join(drummer, "audio", audio_sub, base + ".wav")
            if not os.path.exists(audio):
                continue
            notes = _read_drum_txt(ann, ENST_NAME_MAP)
            tid = f"{dataset}_{dnum}_{base}"
            nf = _notes_npz(data_home, dataset, tid, notes)
            per_split[split].append(_track(tid, audio, nf, notes))
    return {s: _emit(t, data_home, dataset, s)
            for s, t in per_split.items() if t}


def preprocess_egmd(source: str, data_home: str, max_tracks: Optional[int] = None
                    ) -> Dict[str, str]:
    """e-GMD: csv metadata (midi_filename, audio_filename, split)."""
    csv_file = glob.glob(os.path.join(source, "*.csv"))[0]
    per_split: Dict[str, List[dict]] = {}
    with open(csv_file) as f:
        for i, row in enumerate(csv.DictReader(f)):
            if max_tracks and i >= max_tracks:
                break
            split = {"train": "train", "validation": "validation",
                     "test": "test"}.get(row["split"], "train")
            midi = os.path.join(source, row["midi_filename"])
            audio = os.path.join(
                source, os.path.splitext(row["audio_filename"])[0] + ".wav")
            notes = midi2note(midi, force_all_drums=True)
            tid = f"egmd_{i}"
            nf = _notes_npz(data_home, "egmd", tid, notes)
            per_split.setdefault(split, []).append(_track(tid, audio, nf, notes))
    return {s: _emit(t, data_home, "egmd", s) for s, t in per_split.items()}


def preprocess_urmp(source: str, data_home: str) -> Dict[str, str]:
    """URMP: per-piece dirs with AuMix_*.wav + Notes_*_*.txt
    (onset_sec, freq_hz, duration_sec per line) per instrument."""
    URMP_PROG = {"vn": 40, "va": 41, "vc": 42, "db": 43, "fl": 73, "ob": 68,
                 "cl": 71, "sax": 65, "bn": 70, "tpt": 56, "hn": 60,
                 "tbn": 57, "tba": 58, "hp": 46, "gtr": 24}
    tracks = []
    for piece in sorted(glob.glob(os.path.join(source, "[0-9]*"))):
        mixes = glob.glob(os.path.join(piece, "AuMix*.wav"))
        if not mixes:
            continue
        all_notes: List[List[Note]] = []
        for ntxt in sorted(glob.glob(os.path.join(piece, "Notes_*.txt"))):
            parts = os.path.basename(ntxt)[:-4].split("_")
            inst = parts[2] if len(parts) > 2 else "vn"
            prog = URMP_PROG.get(inst, 48)
            notes = []
            with open(ntxt) as f:
                for line in f:
                    vals = line.split()
                    if len(vals) >= 3:
                        on, freq, dur = map(float, vals[:3])
                        pitch = int(round(69 + 12 * np.log2(freq / 440.0)))
                        if 0 <= pitch < 128:
                            notes.append(Note(False, prog, on, on + dur, pitch, 100))
            all_notes.append(notes)
        notes = mix_notes(all_notes)
        tid = "urmp_" + os.path.basename(piece)
        nf = _notes_npz(data_home, "urmp", tid, notes)
        tracks.append(_track(tid, mixes[0], nf, notes))
    # URMP is eval-only in the reference protocol
    return {"test": _emit(tracks, data_home, "urmp", "test")}


def preprocess_singing_json(source: str, data_home: str, dataset: str,
                            split_map: Optional[Dict[str, str]] = None
                            ) -> Dict[str, str]:
    """MIR-ST500 / CMedia style: per-track JSON with [onset, offset, pitch]
    vocal note triplets; audio alongside as wav (pre-extracted)."""
    per_split: Dict[str, List[dict]] = {}
    for ann in sorted(glob.glob(os.path.join(source, "**", "*.json"),
                                recursive=True)):
        base = os.path.splitext(os.path.basename(ann))[0]
        audio = os.path.splitext(ann)[0] + ".wav"
        if not os.path.exists(audio):
            continue
        with open(ann) as f:
            data = json.load(f)
        triplets = data if isinstance(data, list) else data.get("notes", [])
        notes = [Note(False, 100, float(a), float(b), int(round(c)), 100)
                 for a, b, c in triplets if 0 <= round(c) < 128]
        split = (split_map or {}).get(base, "train")
        tid = f"{dataset}_{base}"
        nf = _notes_npz(data_home, dataset, tid, notes)
        per_split.setdefault(split, []).append(_track(tid, audio, nf, notes))
    return {s: _emit(t, data_home, dataset, s) for s, t in per_split.items()}


def preprocess_midi_paired(source: str, data_home: str, dataset: str,
                           split: str = "train", force_drums: bool = False
                           ) -> Dict[str, str]:
    """Generic: any directory of {name.wav, name.mid} pairs (rwc_pop with
    aligned MIDI, idmt_smt_bass, private data)."""
    tracks = []
    for mid in sorted(glob.glob(os.path.join(source, "**", "*.mid"),
                                recursive=True)):
        audio = os.path.splitext(mid)[0] + ".wav"
        if not os.path.exists(audio):
            continue
        notes = midi2note(mid, force_all_drums=force_drums)
        tid = f"{dataset}_" + os.path.splitext(os.path.basename(mid))[0]
        nf = _notes_npz(data_home, dataset, tid, notes)
        tracks.append(_track(tid, audio, nf, notes))
    return {split: _emit(tracks, data_home, dataset, split)}


CONVERTERS: Dict[str, Callable] = {
    "maestro": preprocess_maestro,
    "slakh": preprocess_slakh,
    "guitarset": preprocess_guitarset,
    "enstdrums_dtp": lambda s, d: preprocess_enstdrums(s, d, "dtp"),
    "enstdrums_dtm": lambda s, d: preprocess_enstdrums(s, d, "dtm"),
    "egmd": preprocess_egmd,
    "urmp": preprocess_urmp,
    "mir_st500": lambda s, d: preprocess_singing_json(s, d, "mir_st500"),
    "cmedia": lambda s, d: preprocess_singing_json(s, d, "cmedia"),
    "mir1k": lambda s, d: preprocess_singing_json(s, d, "mir1k"),
    "rwc_pop": lambda s, d: preprocess_midi_paired(s, d, "rwc_pop", "test"),
    "idmt_smt_bass": lambda s, d: preprocess_midi_paired(s, d, "idmt_smt_bass"),
}
