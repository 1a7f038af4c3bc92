"""Training dataset: weighted multi-dataset segment sampler → batches.

Capability parity target: reference `utils/datasets_train.py`
(SURVEY.md C14): pick (file, offset) from index, load audio crop + notes
slice, apply stem submix, tokenize per segment; collate to
(B, input_frames) audio + (B, C, L) token ids. The reference uses torch
DataLoader workers; here a thread prefetcher (or spawned producer
processes) feeds numpy batches, which the train step moves to the device.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config.audio import AudioConfig, DEFAULT_AUDIO
from ..tokens.dataclasses import Note


def dataclasses_replace_pitch(n: Note, semitones: int) -> Note:
    """Pitched notes transpose; drums are unaffected by pitch shift."""
    if n.is_drum:
        return n
    return Note(n.is_drum, n.program, n.onset, n.offset,
                n.pitch + semitones, n.velocity)
from ..tokens.task_manager import TaskManager
from .audio_io import load_audio_file
from .augment import audio_random_submix
from .indexes import load_file_list, load_notes


class _TrackCache:
    """Small LRU of decoded track audio (host RAM)."""

    def __init__(self, capacity: int = 8):
        self.capacity = capacity
        self._d: Dict[str, np.ndarray] = {}
        self._order: List[str] = []
        self._lock = threading.Lock()

    def get(self, path: str, sample_rate: int) -> np.ndarray:
        with self._lock:
            if path in self._d:
                self._order.remove(path)
                self._order.append(path)
                return self._d[path]
        audio, _ = load_audio_file(path, sample_rate)
        with self._lock:
            self._d[path] = audio
            self._order.append(path)
            while len(self._order) > self.capacity:
                self._d.pop(self._order.pop(0), None)
        return audio


class TrainDataset:
    """One (possibly weighted multi-)dataset segment sampler."""

    def __init__(
        self,
        file_lists: Sequence[str],  # index JSON paths
        task_manager: TaskManager,
        audio_cfg: AudioConfig = DEFAULT_AUDIO,
        weights: Optional[Sequence[float]] = None,
        stem_submix: bool = True,
        cross_submix_prob: float = 0.3,  # pool stems from a 2nd track
        submix_p_include: float = 0.8,  # per-stem keep probability
        pitch_shift_semitones: Sequence[int] = (),  # e.g. (-2,-1,0,1,2)
        align_crops: bool = False,  # crop starts on the segment grid
        seed: int = 0,
        cache_tracks: int = 8,
    ):
        self.tm = task_manager
        self.ac = audio_cfg
        self.rng = np.random.default_rng(seed)
        self.stem_submix = stem_submix
        self.cross_submix_prob = cross_submix_prob
        self.submix_p_include = submix_p_include
        self.pitch_shift_semitones = tuple(pitch_shift_semitones)
        self.align_crops = align_crops
        self.cache = _TrackCache(cache_tracks)
        self.datasets = [load_file_list(p) for p in file_lists]
        w = np.asarray(weights if weights is not None
                       else [1.0] * len(self.datasets), np.float64)
        self.weights = w / w.sum()
        self._notes_cache: Dict[str, List[Note]] = {}
        self._notes_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _load_track_notes(self, path: str) -> List[Note]:
        with self._notes_lock:
            if path in self._notes_cache:
                return self._notes_cache[path]
        notes = load_notes(path)
        with self._notes_lock:
            if len(self._notes_cache) > 256:
                self._notes_cache.clear()
            self._notes_cache[path] = notes
        return notes

    def _load_stems(self, track: Dict) -> Tuple[List[np.ndarray], List[List[Note]]]:
        names = list(track["stem_files"].keys())
        sr = self.ac.sample_rate
        audio = [self.cache.get(track["stem_files"][n], sr) for n in names]
        notes = [self._load_track_notes(track["stem_notes"][n])
                 for n in names]
        return audio, notes

    def _sample_stem_track(self, rng: np.random.Generator,
                           exclude_id: Optional[str] = None,
                           attempts: int = 8) -> Optional[Dict]:
        """A random track that has stems (for cross-track submix) —
        dataset chosen by mixture weight, so the 2nd track can come from a
        DIFFERENT dataset (the YourMT3+ cross-dataset trick, SURVEY C13)."""
        for _ in range(attempts):
            ds = self.datasets[int(rng.choice(len(self.datasets),
                                              p=self.weights))]
            track = ds["tracks"][int(rng.integers(0, len(ds["tracks"])))]
            if track.get("stem_files") and track.get("track_id") != exclude_id:
                return track
        return None

    def sample_segment(self, rng: Optional[np.random.Generator] = None
                       ) -> Tuple[np.ndarray, np.ndarray, int]:
        """→ (audio (input_frames,) f32, labels (C, L) i32, pitch_shift_idx).

        When pitch-shift augmentation is on, labels carry the SHIFTED
        pitches and the returned index selects the matching on-device
        audio shift (ops/pitchshift.batched_pitch_shift) — reference
        pitchshift_layer semantics (SURVEY.md C18) split host/device.

        `rng` allows concurrent producers to use independent generators
        (np.random.Generator is not thread-safe)."""
        rng = self.rng if rng is None else rng
        ds = self.datasets[int(rng.choice(len(self.datasets),
                                          p=self.weights))]
        track = ds["tracks"][int(rng.integers(0, len(ds["tracks"])))]
        sr = self.ac.sample_rate
        seg_len = self.ac.input_frames

        use_stems = (self.stem_submix and track.get("stem_files"))
        if use_stems:
            stems_audio, stems_notes = self._load_stems(track)
            other = None
            if self.cross_submix_prob and (rng.random()
                                           < self.cross_submix_prob):
                other = self._sample_stem_track(
                    rng, exclude_id=track.get("track_id"))
            if other is not None:
                from .augment import cross_track_submix
                oa, on = self._load_stems(other)
                audio, notes = cross_track_submix(
                    (stems_audio, stems_notes), (oa, on), rng,
                    p_include=self.submix_p_include)
            else:
                audio, notes = audio_random_submix(
                    stems_audio, stems_notes, rng,
                    p_include=self.submix_p_include)
        else:
            audio = self.cache.get(track["audio_file"], sr)
            notes = self._load_track_notes(track["notes_file"])

        if len(audio) <= seg_len:
            start = 0
            crop = np.zeros(seg_len, np.float32)
            crop[: len(audio)] = audio
        else:
            if self.align_crops:
                n_seg = max(1, (len(audio) - 1) // seg_len)
                start = int(rng.integers(0, n_seg)) * seg_len
            else:
                start = int(rng.integers(0, len(audio) - seg_len))
            crop = np.zeros(seg_len, np.float32)
            avail = audio[start: start + seg_len]
            crop[: len(avail)] = avail
        t0 = start / sr
        shift_idx = 0
        if self.pitch_shift_semitones:
            shift_idx = int(rng.integers(0, len(self.pitch_shift_semitones)))
            s = self.pitch_shift_semitones[shift_idx]
            if s:
                notes = [dataclasses_replace_pitch(n, s) for n in notes]
                notes = [n for n in notes if 0 <= n.pitch <= 127]
        labels = self.tm.tokenize_segment(notes, t0)  # (C, L)
        return crop, labels, shift_idx

    def make_batch(self, batch_size: int,
                   rng: Optional[np.random.Generator] = None
                   ) -> Dict[str, np.ndarray]:
        audio = np.empty((batch_size, self.ac.input_frames), np.float32)
        labels = np.empty((batch_size, self.tm.num_decoding_channels,
                           self.tm.max_token_length), np.int32)
        shifts = np.zeros(batch_size, np.int32)
        for i in range(batch_size):
            a, l, s = self.sample_segment(rng)
            audio[i], labels[i], shifts[i] = a, l, s
        batch = {"audio": audio, "labels": labels}
        if self.pitch_shift_semitones:
            batch["pitch_shift_idx"] = shifts
        return batch

    # --- pickling (process workers): drop locks + warm caches -----------
    def __getstate__(self):
        d = self.__dict__.copy()
        d["cache"] = self.cache.capacity
        d["_notes_cache"] = None
        d["_notes_lock"] = None
        return d

    def __setstate__(self, d):
        cap = d.pop("cache")
        self.__dict__.update(d)
        self.cache = _TrackCache(cap)
        self._notes_cache = {}
        self._notes_lock = threading.Lock()

    def batches(self, batch_size: int, prefetch: int = 4,
                num_workers: int = 1,
                use_processes: Optional[bool] = None
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite prefetched batch iterator.

        num_workers > 1 fans production out over N workers, each with an
        independent child Generator. By default workers are PROCESSES
        (tokenization is pure Python, so threads hit the GIL; the
        reference gets the same isolation from torch DataLoader worker
        processes, SURVEY.md C14). `use_processes=False` forces threads —
        useful when the dataset object can't be pickled or when the C++
        decode path (GIL-releasing) dominates. Batch ORDER is
        nondeterministic across workers; contents stay seed-derived."""
        num_workers = max(1, int(num_workers))
        seeds = np.random.SeedSequence(
            int(self.rng.integers(0, 2**63 - 1))).spawn(num_workers)
        if use_processes is None:
            use_processes = num_workers > 1
        if use_processes and num_workers > 1:
            yield from self._batches_procs(batch_size, prefetch,
                                           num_workers, seeds)
            return

        q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, num_workers))
        stop = threading.Event()

        def worker(seed_seq):
            rng = np.random.default_rng(seed_seq)
            while not stop.is_set():
                batch = self.make_batch(batch_size, rng)
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=1.0)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=worker, args=(s,), daemon=True)
                   for s in seeds]
        for th in threads:
            th.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

    def _batches_procs(self, batch_size, prefetch, num_workers, seeds):
        ctx = mp.get_context("spawn")  # no fork: parent holds a CUDA context
        q = ctx.Queue(maxsize=max(prefetch, num_workers))
        procs = [ctx.Process(target=_producer_proc,
                             args=(self, batch_size, s, q), daemon=True)
                 for s in seeds]
        for p in procs:
            p.start()
        try:
            while True:
                yield q.get()
        finally:
            for p in procs:
                p.terminate()


def _producer_proc(ds: "TrainDataset", batch_size: int, seed_seq, q) -> None:
    rng = np.random.default_rng(seed_seq)
    while True:
        q.put(ds.make_batch(batch_size, rng))
