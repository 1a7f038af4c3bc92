"""Synthetic dataset generator: additive-synth audio + ground-truth notes.

Not in the reference — this replaces its ad-hoc `extras/` sanity scripts
(SURVEY.md §4) with a deterministic, installable fixture dataset: random
note charts rendered as decaying harmonics (+ noise-burst drums), so the
full train→eval→F1 loop runs hermetically in CI and smoke benches.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ...tokens.dataclasses import Note
from ..audio_io import write_wav
from ..indexes import save_notes, write_file_list


# Per-GM-program timbre recipes. Multi-instrument F1 is only learnable if
# programs are acoustically DISTINCT — an earlier renderer gave every
# pitched program the identical (1, .5, .25) harmonic stack, so class
# identity was unobservable and the multi-channel decoder could not
# attribute notes to channels. Each recipe: harmonic amplitude profile,
# attack time, sustain decay rate, and vibrato (rate Hz, depth semitones).
# Registers (pitch ranges) also differ per program — see PROGRAM_RANGES.
PROGRAM_TIMBRES = {
    # program: (harmonic amps, attack_s, decay_per_s, vibrato)
    0:  ((1.0, 0.6, 0.35, 0.2, 0.1), 0.005, 0.9, None),        # piano: rich, percussive decay
    24: ((1.0, 0.45, 0.2, 0.08), 0.003, 2.5, None),            # guitar: pluck, fast decay
    32: ((1.0, 0.25, 0.06), 0.008, 0.9, None),                 # bass: fundamental-heavy
    40: ((1.0, 0.7, 0.55, 0.4, 0.3, 0.2), 0.08, 0.06, (5.5, 0.25)),  # strings: slow bow, vibrato
    56: ((0.7, 1.0, 0.9, 0.7, 0.5, 0.3), 0.04, 0.06, None),    # brass: mid-harmonic formant
    64: ((1.0, 0.15, 0.6, 0.1, 0.4), 0.05, 0.08, (5.0, 0.12)), # reed: odd harmonics, vibrato
}
DEFAULT_TIMBRE = ((1.0, 0.5, 0.25), 0.005, 0.35, None)

PROGRAM_RANGES = {  # MIDI pitch register per program
    # piano reaches 30–95: the sub-guitar and super-guitar octaves give the
    # model UNAMBIGUOUS piano anchors (round-4 piano/guitar confusion:
    # piano test precision 0.102 — the two classes shared register AND
    # decaying-harmonic structure, VERDICT r4 weak-2)
    0: (30, 95), 24: (45, 78), 32: (28, 52), 40: (55, 93),
    56: (52, 80), 64: (49, 78),
}
DEFAULT_RANGE = (45, 84)

# Per-class note-duration ranges (s). Sustained classes hold LONGER notes
# than plucked/struck ones (real-corpus shaped); longer notes also make
# offsets observable — mir_eval's offset tolerance is max(50 ms, 20% of
# ref duration), so a corpus of uniformly short notes put most offsets
# inside a 50 ms window the decoder's 10 ms grid + release masking could
# not hit (flagship offset F1 stuck at 0.37–0.42, VERDICT r4 weak-3).
PROGRAM_DURATIONS = {
    0: (0.2, 2.0), 24: (0.15, 1.0), 32: (0.15, 1.2),
    40: (0.4, 2.5), 56: (0.3, 2.0), 64: (0.3, 2.0),
}
DEFAULT_DURATION = (0.15, 1.2)

# Unison-string detune (cents): pianos strike 2–3 detuned strings per key
# — the resulting beat/chorus is the cheapest strong piano-vs-guitar
# discriminator (a guitar pluck is one string). Applied as extra
# per-partial copies at ±detune.
PROGRAM_UNISON_DETUNE = {0: 1.4}
# Frequency-dependent damping: string damping grows with harmonic number
# (≈ f²); plucked strings lose brightness much faster than struck ones.
# env_h = exp(-t · decay · (1 + hf · (h−1))).
PROGRAM_HF_DAMPING = {24: 0.8, 0: 0.25, 32: 0.5}
# Release: (ramp_s, damper_noise_gain). Piano/guitar offsets announce
# themselves with a damper/mute noise (physically real); sustained
# classes cue the offset by the sustain simply stopping.
PROGRAM_RELEASES = {
    0: (0.05, 0.12), 24: (0.04, 0.10), 32: (0.04, 0.05),
    40: (0.06, 0.0), 56: (0.05, 0.0), 64: (0.05, 0.0),
}
DEFAULT_RELEASE = (0.03, 0.0)
# Mix gain per program: sustained classes ride slightly hotter so their
# release tails stay observable under percussive peers (VERDICT r4 item 4).
PROGRAM_GAINS = {40: 1.3, 56: 1.25, 64: 1.25}

# Onset-transient recipes. Round-3 per-class onset F1 read piano 0.35 /
# guitar 0.37 (vs bass 0.73): the attack-alike classes carried the miss
# (EVIDENCE.md mc13_r5). Real pianos/guitars announce onsets with a broadband
# transient (hammer strike / pluck) the steady-state harmonic stack lacks, so
# the renderer now adds one: (noise_len_s, noise_gain, highpass_like).
# Strings get continuous low-level bow noise instead (no click — their cue
# is the slow swell), and every note gets a small deterministic detune and
# velocity-coupled brightness so timbre varies within a class the way the
# eval corpora (MAESTRO/Slakh audio) do.
PROGRAM_TRANSIENTS = {
    0:  (0.006, 0.55, True),    # piano: hammer click
    24: (0.005, 0.70, True),    # guitar: pluck snap
    32: (0.008, 0.25, False),   # bass: soft thump
    56: (0.015, 0.20, False),   # brass: breath attack
    64: (0.012, 0.18, False),   # reed: chiff
}
# harmonic inharmonicity (stretched partials): f_h = h·f0·sqrt(1 + B·h²)
PROGRAM_INHARMONICITY = {0: 4e-4, 24: 2e-4}

# Full-kit drum timbres for DTM corpora: pitch → (kind, params).
# Pitches are chosen to exercise both the `ksh` (kick/snare/hihat) and
# `gm_drum_8class` eval vocabularies (config/vocabulary.py).
DRUM_TIMBRES = {
    35: ("kick", 55.0), 36: ("kick", 62.0),
    38: ("snare", 190.0), 40: ("snare", 210.0), 37: ("snare", 260.0),
    42: ("hihat", 0.05), 44: ("hihat", 0.04), 46: ("hihat", 0.25),
    41: ("tom", 95.0), 45: ("tom", 130.0), 48: ("tom", 175.0),
    49: ("cymbal", 0.9), 57: ("cymbal", 0.8),
    51: ("ride", 0.45), 53: ("ride", 0.35),
}
FULL_KIT = tuple(sorted(DRUM_TIMBRES))


def _render_drum(rng: np.random.Generator, sr: int, pitch: int,
                 velocity: int) -> np.ndarray:
    """One drum hit as a float64 array; length varies by class."""
    kind, p = DRUM_TIMBRES.get(pitch, ("snare", 200.0))
    v = velocity / 127.0
    if kind == "kick":
        n = int(0.09 * sr)
        t = np.arange(n) / sr
        # pitch-dropping sine thump + short click
        f = p * (1.0 + 1.5 * np.exp(-t * 40))
        body = np.sin(2 * np.pi * np.cumsum(f) / sr) * np.exp(-t * 35)
        click = rng.standard_normal(n) * np.exp(-t * 400) * 0.3
        return 0.55 * v * (body + click)
    if kind == "snare":
        n = int(0.12 * sr)
        t = np.arange(n) / sr
        tone = np.sin(2 * np.pi * p * t) * np.exp(-t * 60) * 0.5
        noise = rng.standard_normal(n) * np.exp(-t * 30)
        return 0.45 * v * (tone + noise)
    if kind == "hihat":
        n = int(max(p, 0.03) * sr)  # p = decay length (s)
        t = np.arange(n) / sr
        noise = rng.standard_normal(n)
        noise = np.diff(noise, prepend=0.0)  # first difference ≈ highpass
        return 0.5 * v * noise * np.exp(-t / max(p / 4, 0.008))
    if kind == "tom":
        n = int(0.15 * sr)
        t = np.arange(n) / sr
        f = p * (1.0 + 0.6 * np.exp(-t * 25))
        body = np.sin(2 * np.pi * np.cumsum(f) / sr) * np.exp(-t * 18)
        return 0.5 * v * body
    # cymbal / ride: inharmonic partial stack + bright noise, long decay
    n = int(max(p, 0.1) * sr)
    t = np.arange(n) / sr
    wave = np.zeros(n)
    for k, f in enumerate((517.0, 813.0, 1279.0, 2113.0, 3331.0)):
        wave += np.sin(2 * np.pi * f * (1.0 + 0.03 * k) * t) / (k + 1)
    noise = np.diff(rng.standard_normal(n), prepend=0.0)
    env = np.exp(-t / max(p / 3, 0.05))
    gain = 0.28 if kind == "cymbal" else 0.22
    return gain * v * (0.5 * wave + noise) * env


def render_notes(notes: Sequence[Note], sr: int, duration: float,
                 seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(sr * duration)
    out = np.zeros(n, np.float64)
    t_all = np.arange(n) / sr
    for note in notes:
        i0 = int(note.onset * sr)
        i1 = min(int(note.offset * sr), n)
        if note.is_drum:
            if i0 >= n:
                continue
            hit = _render_drum(rng, sr, note.pitch, note.velocity)
            i1 = min(i0 + len(hit), n)
            out[i0:i1] += hit[: i1 - i0]
        else:
            if i1 <= i0:
                continue
            f0 = 440.0 * 2 ** ((note.pitch - 69) / 12)
            seg_t = t_all[: i1 - i0]
            harm, attack, decay, vib = PROGRAM_TIMBRES.get(
                note.program, DEFAULT_TIMBRE)
            # Envelope design: offsets must be OBSERVABLE in the audio for
            # offset-F1 to be learnable. An earlier exp(-1.5·t) decay left
            # long notes near-silent well before their labeled offset
            # (offset-F1 cliff: 0.109 vs onset 0.392 zero-shot, round 1);
            # now: attack ramp → per-program sustain decay → sharp 30 ms
            # release ending exactly at the offset.
            attack_env = np.minimum(1.0, seg_t / max(attack, 1e-4))
            rel_s, damper_gain = PROGRAM_RELEASES.get(note.program,
                                                      DEFAULT_RELEASE)
            rel = min(int(rel_s * sr), i1 - i0)
            # deterministic per-note detune (±6 cents) — real instruments
            # are never exactly tempered; keeps the model off a pure-tone
            # frequency lookup
            f0 = f0 * 2 ** (rng.uniform(-6.0, 6.0) / 1200.0)
            phase = 2 * np.pi * f0 * seg_t
            if vib is not None:
                rate, depth_semi = vib
                depth = f0 * (2 ** (depth_semi / 12) - 1.0)
                phase = phase + (depth / rate) * np.sin(2 * np.pi * rate * seg_t)
            # velocity-coupled brightness: soft notes have duller spectra
            bright = 0.55 + 0.45 * (note.velocity / 127.0)
            binh = PROGRAM_INHARMONICITY.get(note.program, 0.0)
            hf_damp = PROGRAM_HF_DAMPING.get(note.program, 0.0)
            det_cents = PROGRAM_UNISON_DETUNE.get(note.program, 0.0)
            # unison copies: 0 (single string) or ±detune around it
            det_ratios = ((1.0,) if det_cents == 0.0 else
                          (2 ** (-det_cents / 1200.0), 1.0,
                           2 ** (det_cents / 1200.0)))
            sig = np.zeros_like(seg_t)
            for h, amp in enumerate(harm, start=1):
                fh = f0 * h * np.sqrt(1.0 + binh * h * h)
                if fh >= sr / 2:
                    continue
                # frequency-dependent damping: upper partials die faster
                env_h = np.exp(-seg_t * decay * (1.0 + hf_damp * (h - 1)))
                partial = np.zeros_like(seg_t)
                for r in det_ratios:
                    partial += np.sin(phase / f0 * (fh * r))
                sig += (amp * bright ** (h - 1) / len(det_ratios)
                        ) * env_h * partial
            sig *= attack_env
            if rel > 0:
                ramp = np.linspace(1.0, 0.0, rel)
                sig[-rel:] *= ramp
                if damper_gain > 0.0:
                    # damper/mute noise at the offset: the audible cue that
                    # the note ENDED (offsets of struck/plucked notes are
                    # otherwise just "decay continues to zero")
                    sig[-rel:] += damper_gain * ramp * np.diff(
                        rng.standard_normal(rel), prepend=0.0)
            trans = PROGRAM_TRANSIENTS.get(note.program)
            if trans is not None:
                tlen_s, tgain, hp = trans
                tn = min(int(tlen_s * sr), i1 - i0)
                if tn > 0:
                    burst = rng.standard_normal(tn)
                    if hp:
                        burst = np.diff(burst, prepend=0.0)
                    sig[:tn] += tgain * burst * np.linspace(1.0, 0.0, tn)
            if vib is not None and note.program == 40:
                # strings: continuous low-level bow noise under the envelope
                env0 = attack_env * np.exp(-seg_t * decay)
                sig += 0.04 * rng.standard_normal(len(seg_t)) * env0
            gain = PROGRAM_GAINS.get(note.program, 1.0)
            out[i0:i1] += (note.velocity / 127.0) * 0.2 * gain * sig
    peak = np.abs(out).max()
    if peak > 1.0:
        out /= peak
    return out.astype(np.float32)


def random_chart(rng: np.random.Generator, duration: float,
                 programs: Sequence[int] = (0, 24, 32),
                 with_drums: bool = True, density: float = 3.0,
                 drum_pitches: Sequence[int] = (36, 38, 42),
                 track_subset: Optional[Tuple[int, int]] = None) -> List[Note]:
    """track_subset=(lo, hi): each TRACK uses a random subset of lo..hi of
    the given programs instead of all of them — real mixtures don't play
    every instrument at once, and a 6-program wall of sound masks release
    tails (offset observability) and blurs class attribution. The subset
    is drawn per chart; over thousands of tracks every program appears in
    sparse AND dense company."""
    notes: List[Note] = []
    if track_subset is not None and len(programs) > track_subset[0]:
        lo, hi = track_subset
        k = int(rng.integers(lo, min(hi, len(programs)) + 1))
        programs = tuple(rng.choice(np.asarray(programs), size=k,
                                    replace=False).tolist())
    n = max(2, int(duration * density))
    for _ in range(n):
        onset = float(rng.uniform(0.05, duration - 0.3))
        if with_drums and rng.random() < 0.3:
            notes.append(Note(True, 128, onset, onset + 0.01,
                              int(rng.choice(drum_pitches)), 100))
        else:
            prog = int(rng.choice(programs))
            lo, hi = PROGRAM_RANGES.get(prog, DEFAULT_RANGE)
            dlo, dhi = PROGRAM_DURATIONS.get(prog, DEFAULT_DURATION)
            notes.append(Note(False, prog, onset,
                              onset + float(rng.uniform(dlo, dhi)),
                              int(rng.integers(lo, hi)), int(rng.integers(60, 110))))
    from ...tokens.note2event import mix_notes
    return mix_notes([notes])


def drum_chart(rng: np.random.Generator, duration: float,
               density: float = 4.0,
               drum_pitches: Sequence[int] = FULL_KIT) -> List[Note]:
    """Drum-only chart for DTM corpora (e-GMD/ENST-shaped workload).

    Mixes a loose groove backbone (8th-note grid kick/snare/hihat with
    per-hit jitter and dropout — DTM models must learn grid-ish timing)
    with off-grid fills over the full kit. Velocities vary so the model
    sees quiet ghost notes next to accents.
    """
    notes: List[Note] = []
    step = 60.0 / float(rng.uniform(90, 150)) / 2  # 8th note at 90-150 bpm
    t = float(rng.uniform(0.05, step))
    k = 0
    while t < duration - 0.1:
        if rng.random() > 0.25:  # dropout
            if k % 4 == 0:
                pitch = 36
            elif k % 4 == 2:
                pitch = 38
            else:
                pitch = int(rng.choice((42, 42, 44, 46)))
            onset = t + float(rng.normal(0, 0.012))
            onset = min(max(onset, 0.01), duration - 0.05)
            notes.append(Note(True, 128, onset, onset + 0.01, pitch,
                              int(rng.integers(50, 120))))
        t += step
        k += 1
    n_fill = max(1, int(duration * max(density - 1.5, 0.5)))
    for _ in range(n_fill):
        onset = float(rng.uniform(0.05, duration - 0.15))
        notes.append(Note(True, 128, onset, onset + 0.01,
                          int(rng.choice(drum_pitches)),
                          int(rng.integers(45, 125))))
    from ...tokens.note2event import mix_notes
    return mix_notes([notes])


def build_synth_dataset(
    root: str, n_tracks: int = 4, duration: float = 6.0, sr: int = 16000,
    splits: Tuple[str, ...] = ("train", "validation", "test"),
    programs: Sequence[int] = (0, 24, 32), with_drums: bool = True,
    seed: int = 0, dataset_name: str = "synth", drums_only: bool = False,
    density: float = 3.0, track_subset: Optional[Tuple[int, int]] = None,
) -> dict:
    """Render tracks + notes and write index files; → {split: index_path}."""
    rng = np.random.default_rng(seed)
    out = {}
    for split in splits:
        tracks = []
        for i in range(n_tracks):
            tid = f"{dataset_name}_{split}_{i:03d}"
            if drums_only:
                chart = drum_chart(rng, duration, density)
            else:
                chart = random_chart(rng, duration, programs, with_drums,
                                     density, track_subset=track_subset)
            audio = render_notes(chart, sr, duration, seed=seed + i)
            adir = os.path.join(root, dataset_name, split)
            os.makedirs(adir, exist_ok=True)
            wav = os.path.join(adir, f"{tid}.wav")
            npz = os.path.join(adir, f"{tid}.npz")
            write_wav(wav, audio, sr)
            save_notes(npz, chart)
            tracks.append({
                "track_id": tid, "audio_file": wav, "notes_file": npz,
                "program_list": sorted({n.program for n in chart if not n.is_drum}),
                "is_drum": any(n.is_drum for n in chart),
                "duration": duration,
            })
        idx = os.path.join(root, "yourmt3_indexes",
                           f"{dataset_name}_{split}_file_list.json")
        write_file_list(idx, tracks, dataset_name, split)
        out[split] = idx
    return out
