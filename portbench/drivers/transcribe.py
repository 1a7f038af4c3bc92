"""Transcription cells: `api.transcribe` in a closed loop, one song at a
time, as one user transcribes a playlist.

Set-up builds the bundle (harness/bundle.py) with the configuration's
decode settings, writes the traffic's seeded songs as float WAVs under the
run's directory and warms every shape the window uses: an encoder batch,
decode steps of the greedy batch and of the beam batch on full-length
caches at the first and the last position (a paged cache's widest
split-KV read and its merge), `warm_steps` greedy and beam steps and the
fast detokenizer, then freezes the objects it made out of the garbage
collector's way. The window starts songs back to back while less than
`seconds` has passed and closes when the last one is done; its rate is
their audio over its whole time. A traced run measures the same window
untraced, for the host-clock metrics, and then traces songs for the
traffic's `trace_seconds` more (0: one song), for the device metrics.

The program's own functions are wrapped, from here, to see what the
window produced: the segment blocks of each pass (`api._padded_batches`),
every greedy and beam decode (ids, steps, host time), every encoder batch,
every detokenizer call and the notes written to MIDI. Once the window has
closed and the program is freed, reference/serve_check.py judges every
served token and every detokenizer call of the songs completed.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time

from harness import bundle as hb
from harness import core, inputs
from harness.trace import DeviceTrace
from reference import serve_check


class Capture(contextlib.AbstractContextManager):
    """Wraps the program's decode, encode, detokenize and MIDI calls."""

    def __init__(self, run: core.Run, bundle):
        from yourmt3_tpu_torch import api
        from yourmt3_tpu_torch.models import decoding
        self.api, self.decoding, self.run = api, decoding, run
        self.tm = bundle.task_manager
        self.songs = []
        self.cur = None
        self.traced = False  # the decodes from now on run under the profiler
        self.orig = {n: getattr(api, n) for n in
                     ("_padded_batches", "greedy_decode", "beam_decode",
                      "_encode_batch", "note_event2midi")}

    def begin(self, index: int) -> None:
        self.cur = {"song": index, "passes": 0, "blocks": [], "decodes": [],
                    "detok": [], "midi": None}
        self.songs.append(self.cur)

    def __enter__(self):
        api, orig, run = self.api, self.orig, self.run
        steps = {"greedy": lambda: self.decoding.greedy_decode.steps,
                 "beam": lambda: self.decoding.beam_decode.steps}

        def padded_batches(segments, rows, batch_size, input_frames):
            self.cur["passes"] += 1
            p = self.cur["passes"]
            for block, chunk in orig["_padded_batches"](segments, rows, batch_size,
                                                         input_frames):
                self.cur["blocks"].append((p, list(block)))
                yield block, chunk

        def decoder(kind):
            fn = orig[kind + "_decode"]

            def wrapped(model, memory, max_length, **kw):
                s0, t0 = steps[kind](), time.perf_counter()
                with run.span(kind + "_decode"):
                    ids = fn(model, memory, max_length, **kw)
                self.cur["decodes"].append({
                    "kind": kind, "ids": ids, "steps": steps[kind]() - s0,
                    "host_s": time.perf_counter() - t0,
                    "rows": memory.shape[0], "channels": memory.shape[1],
                    "real": len(self.cur["blocks"][-1][1]),
                    "beam": kw.get("beam_size", 1), "traced": self.traced})
                return ids
            return wrapped

        def encode(bundle, audio):
            with run.span("encode"):
                return orig["_encode_batch"](bundle, audio)

        def midi(notes, path):
            self.cur["midi"] = notes
            with run.span("write_midi"):
                return orig["note_event2midi"](notes, path)

        detok = self.tm.detokenize_song

        def detokenize(ids, starts, fast=True):
            with run.span("detokenize"):
                notes, errors = detok(ids, starts, fast=fast)
            self.cur["detok"].append({"ids": ids, "starts": list(starts),
                                      "notes": notes})
            return notes, errors

        api._padded_batches = padded_batches
        api.greedy_decode = decoder("greedy")
        api.beam_decode = decoder("beam")
        api._encode_batch = encode
        api.note_event2midi = midi
        self.tm.detokenize_song = detokenize
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.api, name, fn)
        del self.tm.detokenize_song
        return False


def warm_up(bundle, traffic: dict) -> None:
    """Every shape the window uses, once: no compile or first launch in
    the window."""
    import numpy as np
    import torch
    from yourmt3_tpu_torch import api
    model, B = bundle.model, traffic["batch_size"]
    L = bundle.task_manager.max_token_length
    with torch.no_grad():
        audio = np.zeros((B, bundle.audio_cfg.input_frames), np.float32)
        memory = api._encode_batch(bundle, audio)
        streams = memory.shape[0] * memory.shape[1]
        for beam in (1, traffic["repair_beam"]):
            mem = torch.repeat_interleave(memory.reshape(streams, *memory.shape[2:]),
                                          beam, dim=0)[:, None]
            cross = model.init_cross_kv(mem)
            kvs = model.empty_self_kvs(streams * beam, L)
            tok = torch.zeros((streams * beam, 1), dtype=torch.long,
                              device=memory.device)
            for pos in (0, L - 1):  # the first and the widest read of the cache
                logits, kvs = model.decode_step(tok, pos, kvs, cross)
                torch.argmax(logits, dim=-1)
        api.greedy_decode(model, memory, traffic["warm_steps"])
        api.beam_decode(model, memory, traffic["warm_steps"],
                        beam_size=traffic["repair_beam"])
        ids = torch.zeros((1, memory.shape[1], L), dtype=torch.long,
                          device=memory.device)
        bundle.task_manager.detokenize_song(ids, [0.0])


def run(cell: core.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, control=None) -> core.Run:
    import torch
    from yourmt3_tpu_torch import api

    run = core.Run(cell, seed)
    traffic, config = cell.traffic, cell.config
    bundle = hb.build(config, device, seed, mode="serve")
    sr = bundle.audio_cfg.sample_rate
    songs = inputs.songs(seed, traffic, sr)
    tmp = core.run_dir()
    paths = []
    for i, song in enumerate(songs):
        paths.append(os.path.join(tmp, f"song{i}.wav"))
        inputs.write_float_wav(paths[-1], song, sr)
    out_midi = os.path.join(tmp, "out.mid")
    warm_up(bundle, traffic)
    core.sync(device)
    gc.collect()
    gc.freeze()
    run.setup_s = time.perf_counter() - t_start
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    cap = Capture(run, bundle)

    def songs_for(seconds):
        t0 = time.perf_counter()
        while True:
            cap.begin(len(cap.songs) % len(paths))
            run.notes.setdefault("probe_ms", []).append(core.host_probe_ms())
            t_song = time.perf_counter()
            with run.span("transcribe"):
                api.transcribe(bundle, paths[cap.cur["song"]], out_midi,
                               batch_size=traffic["batch_size"],
                               repair_beam=traffic["repair_beam"])
            run.notes.setdefault("song_s", []).append(time.perf_counter() - t_song)
            if time.perf_counter() - t0 >= seconds:
                return

    with cap:
        t0 = time.perf_counter()
        songs_for(seconds)
        core.sync(device)
        run.window_s = time.perf_counter() - t0
        window_songs = list(cap.songs)
        if trace:
            cap.traced = True
            with DeviceTrace() as tracer:
                songs_for(traffic["trace_seconds"])
            run.trace = tracer.summary(run.spans)
    run.peak_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.counts = {"songs": len(cap.songs),
                  "audio_s": sum(len(songs[s["song"]]) / sr for s in window_songs)}
    for s in cap.songs:
        for d in s["decodes"]:
            run.calls.append({k: v for k, v in d.items() if k != "ids"})
    for s in cap.songs:
        serve_check.to_host(s)
    gc.unfreeze()
    del bundle, cap.orig
    core.remove_dir(tmp)
    if cuda:
        torch.cuda.empty_cache()
    run.checks = serve_check.check(config, seed, songs, cap.songs, device,
                                   traffic, cell.limits, control=control)
    return run
