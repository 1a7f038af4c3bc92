"""Training CLI, on the GPU.

    python -m yourmt3_tpu_torch.cli.train my_exp -d synth_smoke -m t5_small
    python -m yourmt3_tpu_torch.cli.train my_exp -d synth_mc -m perceiver_tf_mc13
    torchrun --nproc_per_node 4 -m yourmt3_tpu_torch.cli.train my_exp -b 64 \
        -m perceiver_tf_mc13 -d synth_mc          # data parallel, 16 per card

The flags are the reference's (`yourmt3_tpu/cli/train.py`). Runs on the
CUDA device unless --cpu is given, and raises without one. Under torchrun
(WORLD_SIZE > 1) every rank joins the process group (NCCL, or gloo with
--cpu), -b is the global batch and rank 0 writes the logs and
checkpoints. The data
preset's index files live under $YMT3_DATA_HOME/yourmt3_indexes (build
the synthetic set with data/preprocess/synth.py `build_synth_dataset`).
"""

from __future__ import annotations

import argparse
import contextlib
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a YMT3 model on the GPU")
    p.add_argument("exp_name", nargs="?", default="ymt3_exp")
    p.add_argument("-d", "--data-preset", default="synth_smoke")
    p.add_argument("-t", "--task", default=None,
                   help="task name (defaults to the data preset's task)")
    p.add_argument("-m", "--model", default="t5_small",
                   help="model preset (t5_small, t5_base, perceiver_tf_mc13, ...)")
    p.add_argument("-enc", "--encoder", default=None,
                   help="override encoder type: t5|perceiver-tf|conformer")
    p.add_argument("-b", "--batch-size", type=int, default=16)
    p.add_argument("-s", "--total-steps", type=int, default=10000)
    p.add_argument("-lr", "--learning-rate", type=float, default=1e-3)
    p.add_argument("-o", "--optimizer", default="adamw",
                   choices=["adamw", "adafactor", "dadapt_adam"])
    p.add_argument("--schedule", default="cosine",
                   choices=["cosine", "legacy", "constant"])
    p.add_argument("--warmup-steps", type=int, default=1000)
    p.add_argument("--grad-accum", type=int, default=1,
                   help="gradient accumulation micro-steps")
    p.add_argument("--no-spec-augment", action="store_true")
    p.add_argument("--no-stem-submix", action="store_true")
    p.add_argument("--align-crops", action="store_true",
                   help="crop starts on the segment grid (matches eval slicing)")
    p.add_argument("--pitch-shift", action="store_true",
                   help="±2 semitone on-device pitch augmentation")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=1000)
    p.add_argument("--log-every", type=int, default=50)
    p.add_argument("--resume", default=None, help="checkpoint dir to resume")
    p.add_argument("--init-from", default=None,
                   help="checkpoint dir to warm-start the weights from: fresh "
                        "optimizer state, step 0 and schedule (unlike "
                        "--resume, which restores all three)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-workers", type=int, default=None,
                   help="host batch-producer workers (default: auto from "
                        "CPU count; processes when >1)")
    p.add_argument("--n-data-shards", type=int, default=None,
                   help="ranks the global batch is split over (default "
                        "and only value: the world size)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the training with torch.profiler into DIR and "
                        "print the summary (utils/profiling.py)")
    return p


def main(argv=None) -> str:
    """Parse the flags and train; → the checkpoint directory."""
    args = build_parser().parse_args(argv)

    from ..api import init_model, load_checkpoint
    from ..config.data_presets import get_data_preset
    from ..data.dataset_train import TrainDataset
    from ..parallel import mesh
    from ..train.trainer import MetricLogger, train
    from ..utils import profiling

    preset = get_data_preset(args.data_preset)
    task = args.task or preset.default_task
    device = "cpu" if args.cpu else None
    own_group = int(os.environ.get("WORLD_SIZE", 1)) > 1 and mesh.data_group() is None
    if own_group:
        mesh.init_data_parallel(device=device)
    overrides = {}
    if args.encoder:
        overrides["encoder_type"] = args.encoder
    if args.resume or args.init_from:
        bundle = load_checkpoint(args.resume or args.init_from, device=device)
    else:
        bundle = init_model(args.model, task, seed=args.seed, device=device,
                            **overrides)

    shifts = (-2, -1, 0, 1, 2) if args.pitch_shift else ()
    ds = TrainDataset(preset.index_files("train"), bundle.task_manager,
                      bundle.audio_cfg, weights=preset.weights(),
                      stem_submix=not args.no_stem_submix,
                      pitch_shift_semitones=shifts,
                      align_crops=args.align_crops, seed=args.seed)
    ckpt_dir = args.ckpt_dir or os.path.join("runs", args.exp_name)
    lead = mesh.rank() == 0
    logger = MetricLogger(ckpt_dir, args.exp_name) if lead else None
    num_workers = args.num_workers
    if num_workers is None:  # auto: leave one core for the consumer
        num_workers = max(1, min(4, (os.cpu_count() or 1) - 1))
    batches = ds.batches(args.batch_size, num_workers=num_workers)
    try:
        with (profiling.trace(args.profile) if args.profile
              else contextlib.nullcontext()):
            train(bundle, batches,
                  total_steps=args.total_steps, log_every=args.log_every,
                  ckpt_every=args.ckpt_every, ckpt_dir=ckpt_dir,
                  optimizer=args.optimizer, base_lr=args.learning_rate,
                  schedule=args.schedule, warmup_steps=args.warmup_steps,
                  grad_accum_steps=args.grad_accum,
                  spec_augment=not args.no_spec_augment,
                  pitch_shift_semitones=shifts or None,
                  n_data_shards=args.n_data_shards, seed=args.seed,
                  logger=logger, resume_from=args.resume)
    finally:
        batches.close()  # stops the producer threads or processes
        if logger is not None:
            logger.close()
        if own_group:
            mesh.destroy()
    if lead:
        print(f"done; checkpoints in {ckpt_dir}")
    return ckpt_dir


if __name__ == "__main__":
    main()
