"""Process groups for the port's data- and tensor-parallel tests: `run_ranks` spawns
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
    rendezvous = os.path.join(str(tmp), f"rendezvous_{job.__name__}_{world}")
    mesh.spawn_ranks(job, world, f"file://{rendezvous}", timeout_s=timeout,
                     args=(str(tmp),) + args)


def port_bundle(preset, task, overrides, state_dict=None):
    """The port's fp32 bundle on the CPU at the small audio config, with
    `state_dict` (bridged from JAX) loaded when given; `overrides` may set
    the dropout rate."""
    from yourmt3_tpu_torch.api import init_model
    from yourmt3_tpu_torch.config.audio import AudioConfig
    b = init_model(preset, task, audio_cfg=AudioConfig(**SMALL), device="cpu",
                   **dict(FP32, **overrides))
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
          n_data_shards=world, **spec["train_kw"])
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


def tp_job(rank, world, tmp, n_model, names):
    """Tensor-parallel training on a mesh of (world / n_model, n_model):
    for each case tmp/<name>.pt (weights, global batches, optimizer and
    model options) the parameters are placed with mesh.shard_params and
    trained by make_train_step over the mesh; every rank gathers the
    weights and writes the checkpoint tmp/<name>_tp<n_data>x<n_model>
    (rank 0 writes), and rank 0 its metrics and gathered weights to
    tmp/<name>_tp<n_data>x<n_model>.pt. Every rank seeds its generator
    as one process does and draws the masks of one process. An all-gather into
    one tensor (which gloo on CUDA tensors does not carry) raises here."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    from yourmt3_tpu_torch.parallel import mesh
    from yourmt3_tpu_torch.train.checkpoint import save_bundle

    def refuse(*args, **kwargs):  # gloo cannot carry it on CUDA tensors
        raise RuntimeError("the tensor-parallel step issued an all-gather into "
                           "one tensor")
    dist.all_gather_into_tensor = funcol.all_gather_tensor = refuse
    n_data = world // n_model
    m = mesh.make_mesh(n_data, n_model, device="cpu")
    for name in names:
        spec = torch.load(os.path.join(tmp, f"{name}.pt"), weights_only=False)
        b = tp_bundle(spec)
        mesh.shard_params(m, b.model)
        metrics, weights, _ = tp_steps(b, spec, m)
        tag = f"{name}_tp{n_data}x{n_model}"
        save_bundle(os.path.join(tmp, tag), b, step=len(spec["batches"]))
        if rank == 0:
            torch.save(dict(metrics=metrics, weights=weights), os.path.join(tmp, f"{tag}.pt"))


def tp_bundle(spec):
    """The port's fp32 bundle of a tensor-parallel case, with its weights
    (spec's state dict, or init_model's seed-0 weights where it is None;
    spec's overrides may set the dropout rate; `fp32_projection` builds
    the group projection in fp32 instead of bf16)."""
    from yourmt3_tpu_torch.api import init_model
    from yourmt3_tpu_torch.config.audio import AudioConfig
    from yourmt3_tpu_torch.models import projection
    bf16 = projection.BF16
    if spec.get("fp32_projection"):
        projection.BF16 = torch.float32
    try:
        b = init_model(spec["preset"], spec["task"], audio_cfg=AudioConfig(**SMALL),
                       device="cpu", **dict(FP32, **spec["overrides"]))
    finally:
        projection.BF16 = bf16
    if spec["state_dict"] is not None:
        b.model.load_state_dict(spec["state_dict"], strict=True)
    return b


def tp_steps(bundle, spec, group=None):
    """spec's steps through make_train_step over `group` (None: one
    process); → (metrics by step, the whole weights on the CPU after each
    step, and in one process the gradients the optimizer was fed at each
    step)."""
    from yourmt3_tpu_torch.ops.specaugment import make_augment_fn
    from yourmt3_tpu_torch.parallel import mesh
    from yourmt3_tpu_torch.train.checkpoint import _to_cpu
    from yourmt3_tpu_torch.train.optim import GradientTransformation, make_optimizer
    from yourmt3_tpu_torch.train.train_step import create_train_state, make_train_step
    tx = make_optimizer(spec["optimizer"], spec["lr"], "constant", 1, len(spec["batches"]))
    grads = []
    if group is None:
        def update(g, opt_state, params=None, inner=tx.update):
            grads.append({k: v.clone() for k, v in g.items()})
            return inner(g, opt_state, params)
        tx = GradientTransformation(tx.init, update)
    step = make_train_step(bundle.model, bundle.frontend, tx, group=group,
                           augment_fn=make_augment_fn() if spec["spec_augment"] else None)
    state = create_train_state(bundle.model, tx)
    gen = torch.Generator().manual_seed(0)
    metrics, weights = [], []
    for batch in spec["batches"]:
        if group is not None:
            batch = mesh.shard_batch(batch, group)
        state, out = step(state, batch, gen)
        metrics.append({k: float(v) for k, v in out.items()})
        # copies: on the CPU the gathered state dict shares the parameters'
        # storage, which the next step updates in place
        weights.append({k: v.clone() for k, v in _to_cpu(bundle.model.state_dict()).items()})
    return metrics, weights, grads


def rounding_band(g, tol):
    """The elements of gradient `g` that are nonzero and within tol · rms
    of zero, the rms taken over each row (the last axis) of a matrix or
    over the whole of a vector."""
    a = g.abs()
    rms = a.pow(2).mean(-1, keepdim=True).sqrt() if a.ndim > 1 else a.pow(2).mean().sqrt()
    return (a > 0) & (a <= tol * rms)


def check_weights(got, want, first_grad, sensitive, what, tol, tol_sensitive, band_max):
    """Each tensor by ||got - want|| / ||want||: `tol`, or `tol_sensitive`
    over the `sensitive` tensors' elements outside the rounding band. The
    band is a rule on the one-process step's first gradient `first_grad`,
    whose sensitive tensors (upstream of a bf16 group projection) agree to
    bf16's rounding only: Adam's first step is about lr · sign(g), and it
    turns where the element's g is nonzero and within tol_sensitive · rms
    of zero (the rms of its row: the gradient's rounding scales with the
    terms summed into the row, which are small in a rarely chosen
    expert's). At most band_max of the elements may lie in the band."""
    worst, kind = {}, {}
    n_band = n_all = 0
    for k, v in want.items():
        t = tol_sensitive if k in sensitive else tol
        band = rounding_band(first_grad[k], t) if k in sensitive else torch.zeros_like(
            v, dtype=torch.bool)
        keep = ~band
        n_band, n_all = n_band + int(band.sum()), n_all + v.numel()
        kind[k] = ("bias" if k.endswith(".bias") else "upstream rel" if k in sensitive
                   else "rel")
        err = ((got[k] - v)[keep].norm() / v[keep].norm()).item() if keep.any() else 0.0
        worst[k] = (err / t, err)
    for group in sorted(set(kind.values())):
        k = max((n for n in worst if kind[n] == group), key=lambda n: worst[n])
        print(f"{what}: worst {group} {k} {worst[k][1]:.3e} "
              f"({worst[k][0]:.3f} of its tolerance)")
    print(f"{what}: {n_band} of {n_all} elements in the rounding band")
    k = max(worst, key=lambda n: worst[n])
    assert worst[k][0] <= 1.0, (k, worst[k])
    assert n_band <= band_max * n_all, (n_band, n_all)

