"""Evaluation CLI: a checkpoint's F1 tables on a data preset's split.

    python -m yourmt3_tpu_torch.cli.test -ckpt runs/exp/last -d synth_smoke

Restores a checkpoint written by the port's trainer (train/checkpoint.py),
decodes every track of the preset's split and prints the metric dict per
dataset. Runs on the CUDA device unless --cpu is given. Inside a process
group (or under torchrun, WORLD_SIZE > 1, which joins one) each song is
decoded chunk-parallel over the ranks, -b segments per rank
(eval/evaluator.py `mesh`; plain greedy only: --beam-size,
--repetition-guard and --repair-beam raise there); rank 0 prints and
writes the JSON.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> dict:
    """Parse the flags, evaluate; → {dataset: metric dict}."""
    p = argparse.ArgumentParser(description="Evaluate a YMT3 checkpoint")
    p.add_argument("-ckpt", "--checkpoint", required=True)
    p.add_argument("-d", "--data-preset", default="synth_smoke")
    p.add_argument("--split", default="test")
    p.add_argument("-b", "--batch-size", type=int, default=8)
    p.add_argument("--max-tracks", type=int, default=None)
    p.add_argument("--subtask", default=None)
    p.add_argument("--output-json", default=None)
    p.add_argument("--kv-quant", default=None,
                   choices=("none", "int8", "int8c4", "int8c4p", "int4"),
                   help="override the decode KV-cache format (the weights "
                        "are unchanged, only the model object is rebuilt)")
    p.add_argument("--weight-quant", default=None,
                   choices=("none", "bf16", "int8"),
                   help="override the decoder-weight decode format "
                        "(ops/weight_quant.py)")
    p.add_argument("--repetition-guard", type=int, default=0,
                   help="force-EOS a stream after N consecutive identical "
                        "tokens (0 = off, else >= 2)")
    p.add_argument("--beam-size", type=int, default=1,
                   help="per-segment batched beam search (1 = greedy)")
    p.add_argument("--repair-beam", type=int, default=0,
                   help=">1: re-decode only the segments the detokenizer "
                        "rejects with beam search of this width")
    p.add_argument("--eval-drum-vocab", default=None,
                   help="override the preset's eval drum vocabulary "
                        "(gm_drum_full | ksh | gm_drum_8class)")
    p.add_argument("--eval-program-vocab", default=None,
                   help="override the preset's eval program vocabulary")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    args = p.parse_args(argv)

    from ..api import load_checkpoint
    from ..config.data_presets import get_data_preset
    from ..data.dataset_eval import AudioFileDataset
    from ..eval.evaluator import evaluate_file_dataset
    from ..parallel import mesh

    device = "cpu" if args.cpu else None
    own_group = int(os.environ.get("WORLD_SIZE", 1)) > 1 and mesh.data_group() is None
    if own_group:
        mesh.init_data_parallel(device=device)
    group = mesh.data_group()
    lead = mesh.rank(group) == 0
    ov = {}
    if args.kv_quant is not None:
        ov["kv_quant"] = args.kv_quant
    if args.weight_quant is not None:
        ov["weight_quant"] = args.weight_quant
    bundle = load_checkpoint(args.checkpoint, device=device, **ov)
    preset = get_data_preset(args.data_preset)
    results = {}
    for entry, idx in zip(preset.entries, preset.index_files(args.split)):
        if lead:
            print(f"== {entry.dataset} ({args.split}) ==")
        ds = AudioFileDataset(idx, bundle.audio_cfg, max_tracks=args.max_tracks)
        res = evaluate_file_dataset(
            bundle, ds,
            eval_program_vocab=(args.eval_program_vocab
                                or entry.eval_program_vocab),
            eval_drum_vocab=args.eval_drum_vocab or entry.eval_drum_vocab,
            batch_size=args.batch_size, subtask=args.subtask,
            beam_size=args.beam_size,
            repetition_guard=args.repetition_guard,
            repair_beam=args.repair_beam, mesh=group,
            segments_per_device=args.batch_size)
        results[entry.dataset] = res
        if not lead:
            continue
        print("  " + " ".join(f"{k}={v:.4f}" for k, v in res.items()
                              if isinstance(v, float)))
        for name, row in res.get("per_class", {}).items():
            print(f"    {name:<14} onset_f1={row['f1']:.4f} "
                  f"P={row['precision']:.4f} R={row['recall']:.4f} "
                  f"n_ref={row['n_ref']}")
    if args.output_json and lead:
        with open(args.output_json, "w") as f:
            json.dump(results, f, indent=2)
    if own_group:
        mesh.destroy()
    return results


if __name__ == "__main__":
    main()
