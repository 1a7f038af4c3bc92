"""Process groups for the port's data-parallel tests: `run_ranks` spawns
`world` processes on the CPU that join one gloo group through a file://
rendezvous under the test's tmp_path and run one of the jobs below
(`module_job` runs them all in one group); the join has a timeout of its
own, so a stuck rank fails the test instead of hanging the run. This module imports nothing of JAX: the spawned
processes load it. Inputs and results cross as files in tmp_path."""

import dataclasses
import os
import pickle

import numpy as np
import torch

JOIN_TIMEOUT_S = 180.0
# the small audio config of the JAX package's own tests
SMALL = dict(input_frames=4095, n_fft=512, hop_length=128, n_mels=64)
FP32 = dict(compute_dtype="float32", dropout_rate=0.0)


def run_ranks(job, world: int, tmp, *args, timeout: float = JOIN_TIMEOUT_S) -> None:
    """Run job(rank, world, tmp, *args) in `world` gloo ranks on the CPU
    (mesh.spawn_ranks); raise what a rank raised, or TimeoutError after
    `timeout` seconds."""
    from yourmt3_tpu_torch.parallel import mesh
    rendezvous = os.path.join(str(tmp), f"rendezvous_{job.__name__}")
    mesh.spawn_ranks(job, world, f"file://{rendezvous}", timeout_s=timeout,
                     args=(str(tmp),) + args)


def port_bundle(preset, task, overrides, state_dict=None):
    """The port's fp32 bundle on the CPU at the small audio config, with
    `state_dict` (bridged from JAX) loaded when given."""
    from yourmt3_tpu_torch.api import init_model
    from yourmt3_tpu_torch.config.audio import AudioConfig
    b = init_model(preset, task, audio_cfg=AudioConfig(**SMALL), device="cpu",
                   **FP32, **overrides)
    if state_dict is not None:
        b.model.load_state_dict(state_dict, strict=True)
    return b


def notes_key(notes):
    return [dataclasses.astuple(n) for n in notes]


# ---------------------------------------------------------------------------
# jobs (each runs in every rank)
# ---------------------------------------------------------------------------

def module_job(rank, world, tmp, train_names):
    """Every job of tests/test_torch_parallel.py in one group: train_job
    for each name, then chunk_job."""
    for name in train_names:
        train_job(rank, world, tmp, name)
    chunk_job(rank, world, tmp)


def train_job(rank, world, tmp, name):
    """trainer.train over the group on tmp/<name>.pt's global batches;
    rank 0 writes the log and checkpoint under tmp/<name>, every rank its
    final weights to tmp/<name>_rank<r>.pt."""
    from yourmt3_tpu_torch.train.trainer import train
    spec = torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=False)
    b = port_bundle(spec["preset"], spec["task"], spec["overrides"], spec["state_dict"])
    train(b, iter(spec["batches"]), total_steps=len(spec["batches"]), log_every=1,
          ckpt_every=len(spec["batches"]), ckpt_dir=os.path.join(tmp, name),
          spec_augment=False, n_data_shards=world, **spec["train_kw"])
    torch.save(b.model.state_dict(), os.path.join(tmp, f"{name}_rank{rank}.pt"))


def chunk_job(rank, world, tmp):
    """Chunk-parallel transcription of tmp/chunk.pt's song and of an
    empty song over the default group, mesh.replicate of weights that
    differ by rank, evaluate_file_dataset with the group as its mesh, and
    the evaluator's refusals; → a pickle per rank."""
    from yourmt3_tpu_torch.data.dataset_eval import AudioFileDataset
    from yourmt3_tpu_torch.eval.evaluator import evaluate_file_dataset
    from yourmt3_tpu_torch.parallel import mesh
    from yourmt3_tpu_torch.parallel.chunk_stream import transcribe_song_chunk_parallel
    spec = torch.load(os.path.join(tmp, "chunk.pt"), weights_only=False)
    b = port_bundle(spec["preset"], spec["task"], {}, spec["state_dict"])
    spd, L = spec["segments_per_device"], spec["max_length"]
    notes, errs = transcribe_song_chunk_parallel(
        b, spec["song"], segments_per_device=spd, max_length=L)
    empty, _ = transcribe_song_chunk_parallel(b, np.zeros(100, np.float32),
                                              segments_per_device=1, max_length=L)
    group = mesh.data_group()
    rank_weights = torch.nn.Linear(3, 2)
    torch.nn.init.constant_(rank_weights.weight, float(rank + 1))
    torch.nn.init.constant_(rank_weights.bias, float(rank + 1))
    replicated = mesh.replicate(rank_weights).weight.tolist()
    metrics = evaluate_file_dataset(b, AudioFileDataset(spec["split"], b.audio_cfg),
                                    verbose=False, mesh=group, segments_per_device=spd)
    refused = {}
    seg_s = b.audio_cfg.input_frames / b.audio_cfg.sample_rate
    segs = np.zeros((3, b.audio_cfg.input_frames), np.float32)
    for what, ds, kw in [
            ("beam", [("t", segs, [0.0, seg_s, 2 * seg_s], [])], dict(beam_size=2)),
            ("repetition", [("t", segs, [0.0, seg_s, 2 * seg_s], [])],
             dict(repetition_guard=3)),
            ("repair", [("t", segs, [0.0, seg_s, 2 * seg_s], [])], dict(repair_beam=2)),
            ("contiguous", [("t", segs, [0.0, seg_s / 2, seg_s], [])], {})]:
        try:
            evaluate_file_dataset(b, ds, verbose=False, mesh=group, **kw)
        except ValueError as e:
            refused[what] = str(e)
    with open(os.path.join(tmp, f"chunk_rank{rank}.pkl"), "wb") as f:
        pickle.dump(dict(notes=notes_key(notes), errors=dataclasses.asdict(errs),
                         empty=empty, metrics=metrics, refused=refused,
                         replicated=replicated), f)
