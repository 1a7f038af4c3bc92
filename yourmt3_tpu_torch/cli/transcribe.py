"""One-shot transcription CLI: audio file(s) → MIDI, on the GPU.

    python -m yourmt3_tpu_torch.cli.transcribe song.wav -o out/ --decode-path fast
    python -m yourmt3_tpu_torch.cli.transcribe --url https://youtu.be/... -o out/

Runs on the CUDA device unless --cpu is given. -ckpt restores a
checkpoint written by the port's trainer; without one the model is
randomly initialized from --seed (a smoke run).
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Parse the flags, transcribe every input; → the MIDI paths written."""
    p = argparse.ArgumentParser(description="Transcribe audio → MIDI")
    p.add_argument("inputs", nargs="*", help="audio files (wav, flac)")
    p.add_argument("--url", default=None,
                   help="YouTube URL (needs network access and yt-dlp)")
    p.add_argument("-ckpt", "--checkpoint", default=None,
                   help="checkpoint dir written by the port's trainer; omit "
                        "for a randomly initialized model (smoke only)")
    p.add_argument("-m", "--model", default="t5_small")
    p.add_argument("-t", "--task", default="mt3_full_plus")
    p.add_argument("-o", "--output-dir", default=".")
    p.add_argument("-b", "--batch-size", type=int, default=8)
    p.add_argument("--subtask", default=None)
    p.add_argument("--decode-path", choices=("fast", "exact"),
                   default="exact",
                   help="exact = bf16 KV decode; fast = int8 KV (paged "
                        "decode-attention kernel for long single-channel "
                        "decodes)")
    p.add_argument("--beam-size", type=int, default=1,
                   help=">1 decodes every segment with batched beam search")
    p.add_argument("--repetition-guard", type=int, default=0,
                   help="force-EOS a stream after N consecutive identical "
                        "tokens (0 = off, else >= 2)")
    p.add_argument("--repair-beam", type=int, default=2,
                   help="segments the detokenizer rejects are re-decoded "
                        "with beam search of this width and kept only if "
                        "errors drop; 0 = raw greedy")
    p.add_argument("--weight-quant", default=None,
                   choices=("none", "bf16", "int8"),
                   help="decoder-weight decode format: bf16, or int8 with "
                        "per-output-channel scales (default: fp32 master)")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random init when no checkpoint is given")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the transcriptions with torch.profiler into "
                        "DIR and print the summary (utils/profiling.py)")
    args = p.parse_args(argv)

    inputs = list(args.inputs)
    if args.url:
        try:
            import yt_dlp  # noqa: F401
        except ImportError:
            raise SystemExit("YouTube ingestion requires yt-dlp + network; "
                             "unavailable in this environment. Pass a local "
                             "audio file instead.")
        import tempfile

        from ..app import fetch_youtube_audio
        inputs.append(fetch_youtube_audio(
            args.url, tempfile.mkdtemp(prefix="ymt3_yt_")))
    if not inputs:
        raise SystemExit("no input files")

    from ..api import (fast_decode_overrides, init_model, load_checkpoint,
                       transcribe)
    from ..tokens.task_manager import TaskManager
    from ..train.checkpoint import read_meta
    from ..utils import profiling

    device = "cpu" if args.cpu else None
    task = read_meta(args.checkpoint).get("task", args.task) if args.checkpoint \
        else args.task
    tm = TaskManager(task)
    ov = (fast_decode_overrides(tm.num_decoding_channels, tm.max_token_length)
          if args.decode_path == "fast" else {})
    if args.weight_quant:
        ov["weight_quant"] = args.weight_quant
    if args.checkpoint:
        bundle = load_checkpoint(args.checkpoint, device=device, **ov)
    else:
        bundle = init_model(args.model, args.task, seed=args.seed,
                            device=device, **ov)
    os.makedirs(args.output_dir, exist_ok=True)
    outs = []
    with (profiling.trace(args.profile) if args.profile
          else contextlib.nullcontext()):
        for path in inputs:
            out = os.path.join(
                args.output_dir,
                os.path.splitext(os.path.basename(path))[0] + ".mid")
            mid = transcribe(bundle, path, out, batch_size=args.batch_size,
                             subtask=args.subtask, beam_size=args.beam_size,
                             repetition_guard=args.repetition_guard,
                             repair_beam=args.repair_beam)
            print(f"{path} -> {mid}")
            outs.append(mid)
    return outs


if __name__ == "__main__":
    main()
