"""Entry points of the port for a compile check and a multi-process dry
run (the counterparts of the repository's `__graft_entry__.py`).

    python -m yourmt3_tpu_torch.graft_entry [n]   # dry run over n CPU ranks

`entry()` gives the flagship's teacher-forced forward step at full width.
`dryrun_multichip(n)` starts n gloo processes on the CPU; each runs one
DistributedDataParallel train step of t5_tiny and of a tiny MoE flagship
on its shard of a global batch, then a song's chunk-parallel decode over
the n ranks, which must give the notes and errors of the decode on one
rank. The tensor-parallel layouts of the reference's dry run are not
ported.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

# the two models of the dry run: the T5 family and a tiny-width flagship
# (conv pre-encoder, Perceiver-TF with an MoE FF, group projection,
# 13-channel decoder)
DRYRUN_MODELS = (
    ("t5_tiny", "mt3_full_plus", {}),
    ("perceiver_tf_mc13_moe", "mc13_full_plus_256", dict(
        d_model=64, d_kv=16, num_heads=4, d_ff=128, num_decoder_layers=2,
        ptf_num_latents=26, ptf_d_latent=32, ptf_num_blocks=1,
        ptf_num_moe_experts=4)),
)
# a small audio config keeps the CPU dry run fast; the model code is the same
DRYRUN_AUDIO = dict(input_frames=4095, n_fft=512, hop_length=128, n_mels=64)


def entry(device=None):
    """→ (forward, (audio, labels)): the flagship's forward step (log-mel
    frontend → Perceiver-TF encoder → group projection → 13-channel T5
    decoder, teacher forced) at full width on `device` (default: CUDA),
    random weights from seed 0."""
    from .api import init_model
    from .models.ymt3 import shift_right

    bundle = init_model("perceiver_tf_mc13", "mc13_full_plus_256", device=device)
    model, fe = bundle.model, bundle.frontend
    B, C, L = 1, bundle.cfg.num_channels, 64

    def forward(audio, labels):
        return model(fe(audio), shift_right(labels))

    rng = np.random.default_rng(0)
    audio = torch.from_numpy(
        rng.standard_normal((B, bundle.audio_cfg.input_frames)).astype(np.float32)
        * 0.1).to(bundle.device)
    labels = torch.from_numpy(rng.integers(3, bundle.cfg.vocab_size, (B, C, L))).to(
        bundle.device)
    return forward, (audio, labels)


def _dryrun_rank(rank: int, world: int) -> None:
    import torch.distributed as dist

    from .api import init_model
    from .config.audio import AudioConfig
    from .parallel import mesh
    from .parallel.chunk_stream import transcribe_song_chunk_parallel
    from .train.optim import make_optimizer
    from .train.train_step import create_train_state, make_train_step

    group = mesh.data_group()
    ac = AudioConfig(**DRYRUN_AUDIO)
    rng = np.random.default_rng(0)  # the same global batch on every rank
    for preset, task, overrides in DRYRUN_MODELS:
        bundle = init_model(preset, task, audio_cfg=ac, device="cpu", **overrides)
        tx = make_optimizer("adamw", 1e-3, "cosine", warmup_steps=10,
                            total_steps=100)
        step = make_train_step(bundle.model, bundle.frontend, tx, group=group)
        B = 2 * world
        batch = {"audio": rng.standard_normal((B, ac.input_frames)).astype(
                     np.float32) * 0.1,
                 "labels": rng.integers(3, bundle.cfg.vocab_size,
                                        (B, bundle.cfg.num_channels, 32))}
        _, metrics = step(create_train_state(bundle.model, tx),
                          mesh.shard_batch(batch, group), None)
        loss = float(metrics["loss"])
        assert np.isfinite(loss), f"non-finite loss {loss}"
        if rank == 0:
            print(f"dryrun_multichip {preset} data={world} ok: loss={loss:.4f}",
                  flush=True)

    bundle = init_model("t5_tiny", "mt3_full_plus", audio_cfg=ac, device="cpu")
    song = (rng.standard_normal(int(ac.sample_rate * 2.6)) * 0.1).astype(np.float32)
    notes, errs = transcribe_song_chunk_parallel(
        bundle, song, group, segments_per_device=2, max_length=16)
    # every rank builds every one-rank group, in the same order
    alone = [dist.new_group([r]) for r in range(world)][rank]
    ref_notes, ref_errs = transcribe_song_chunk_parallel(
        bundle, song, alone, segments_per_device=2 * world, max_length=16)
    assert isinstance(notes, list)
    assert notes == ref_notes, (
        f"chunk-parallel notes != one-rank notes ({len(notes)} vs {len(ref_notes)})")
    assert errs == ref_errs, (errs, ref_errs)
    if rank == 0:
        print(f"dryrun_multichip chunk_parallel data={world} ok: notes={len(notes)} "
              f"decode_errors={errs.total()} == one rank", flush=True)


def dryrun_multichip(n_devices: int, timeout_s: float = 600.0) -> None:
    """One DDP train step per dry-run model and the chunk-parallel
    equivalence check over `n_devices` gloo processes on the CPU; raises
    what a rank raised, or TimeoutError."""
    from .parallel import mesh
    with tempfile.TemporaryDirectory() as tmp:
        mesh.spawn_ranks(_dryrun_rank, n_devices,
                         f"file://{os.path.join(tmp, 'rendezvous')}",
                         timeout_s=timeout_s)


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
