"""Checkpoints in the port's own format.

A checkpoint directory holds
    params.pt       the model's fp32 master state dict (torch.save)
    opt_state.pt    {"step": int, "opt_state": nested dict} (optional)
    ymt3_meta.json  preset, task, step, the full audio config and the full
                    model config (the same metadata as the reference's
                    train/checkpoint.py)
Both .pt files hold only tensors, ints and dicts, and are read back with
`torch.load(weights_only=True)`. Each file is written to a temporary name
and renamed, so a preempted write never leaves a torn checkpoint. The
decoder's quantized side-car weights are not saved: loading the state
dict rebuilds them from the restored masters. A model sharded over the
`model` axis (parallel/mesh.shard_params) is saved whole: every rank
gathers the shards and rank 0 writes.

An Orbax checkpoint of the JAX package (a `params/` directory, no
params.pt) restores through a reference-style export placed beside it as
`REFERENCE_EXPORT` (see `restore_bundle`); the Orbax files themselves are
zstd-compressed tensorstore data that this package does not read.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..parallel.tensor_parallel import full_tensor

META_NAME = "ymt3_meta.json"
PARAMS_NAME = "params.pt"
OPT_NAME = "opt_state.pt"
# the weights of a JAX package checkpoint, exported as a reference-style
# state dict by EXPORT_RECIPE (run where the JAX package is installed)
REFERENCE_EXPORT = "reference_export.ckpt"
EXPORT_RECIPE = (
    "python -c \"import sys, torch; from yourmt3_tpu.train.checkpoint import "
    "restore_bundle; from yourmt3_tpu.train.import_torch import "
    "reference_style_state_dict as ref; d = sys.argv[1]; "
    "torch.save({'state_dict': {k: torch.from_numpy(v.copy()) for k, v in "
    "ref(restore_bundle(d).params).items()}}, d + '/" + REFERENCE_EXPORT
    + "')\" <checkpoint dir>")


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _to_cpu(tree):
    """Detached CPU copies of every tensor of a nested dict; a tensor
    sharded over the model axis is gathered whole (a collective of its
    group)."""
    if isinstance(tree, torch.Tensor):
        return full_tensor(tree.detach()).cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_bundle(path: str, bundle, step: int = 0,
                opt_state: Optional[dict] = None) -> None:
    """Write the master weights (+ optional optimizer state) and metadata.

    With parameters sharded over the model axis every rank must call this:
    the tensors are gathered whole, and rank 0 of the default group alone
    writes."""
    params = _to_cpu(bundle.model.state_dict())
    opt = None if opt_state is None else _to_cpu(opt_state)
    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        return
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _atomic_save(params, os.path.join(path, PARAMS_NAME))
    if opt is not None:
        _atomic_save({"step": int(step), "opt_state": opt},
                     os.path.join(path, OPT_NAME))
    meta = {
        "model_preset": bundle.cfg.name,
        "task": bundle.task_manager.task.name,
        "step": int(step),
        # the full audio config: a non-default frontend restores exactly
        "audio": dataclasses.asdict(bundle.audio_cfg),
        # the full model config: dim overrides survive a restore
        "model": dataclasses.asdict(bundle.cfg),
    }
    tmp = os.path.join(path, META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=2)
    os.replace(tmp, os.path.join(path, META_NAME))


def read_meta(path: str) -> dict:
    meta_path = os.path.join(os.path.abspath(path), META_NAME)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def config_from_meta(model_meta: dict):
    """The ModelConfig a checkpoint's metadata records, with the JAX
    package's two rules for older checkpoints: a Perceiver-TF config
    written before `encoder_abs_pos` existed restores with "none" (it was
    trained without the sinusoid), and a conformer one with "sinusoidal"
    draws a warning. Unknown keys (a newer writer's) are ignored."""
    from ..config.model import ModelConfig
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in model_meta.items() if k in known}
    if (kw.get("encoder_type") == "perceiver-tf"
            and "encoder_abs_pos" not in model_meta):
        kw["encoder_abs_pos"] = "none"
        print("note: pre-encoder_abs_pos checkpoint — restoring with "
              "encoder_abs_pos='none' to match its training forward")
    if (kw.get("encoder_type") == "conformer"
            and kw.get("encoder_abs_pos") == "sinusoidal"):
        print("warning: conformer checkpoint with "
              "encoder_abs_pos='sinusoidal' — if it was trained in the "
              "pre-gate window (per-block injection), restore with "
              "model_cfg.replace(encoder_abs_pos='sinusoidal_per_block')"
              " to match its training forward")
    return ModelConfig(**kw)


def restore_bundle(path: str, model_preset: Optional[str] = None,
                   task: Optional[str] = None, audio_cfg=None, device=None,
                   **cfg_overrides):
    """Rebuild the bundle a checkpoint was written from. cfg_overrides are
    inference-time ModelConfig fields (kv_quant, use_pallas_decode,
    weight_quant): they never change the parameters, so the restored
    weights apply unchanged and the side-car weights follow them.

    A checkpoint of the JAX package (`params/` written by Orbax, no
    params.pt) is rebuilt from its ymt3_meta.json, and its weights are
    read from the reference-style state dict `REFERENCE_EXPORT` beside it
    through `import_reference.import_checkpoint(require_complete=True)`.
    Where that file is missing this raises FileNotFoundError with
    EXPORT_RECIPE, the one line that writes it with the JAX package's own
    `restore_bundle` and `reference_style_state_dict`."""
    from ..api import init_model
    from ..config.audio import AudioConfig
    path = os.path.abspath(path)
    params_path = os.path.join(path, PARAMS_NAME)
    orbax = not os.path.exists(params_path)
    if orbax:
        if not os.path.isdir(os.path.join(path, "params")):
            raise FileNotFoundError(f"no checkpoint in {path} (no {PARAMS_NAME})")
        export = os.path.join(path, REFERENCE_EXPORT)
        if not os.path.exists(export):
            raise FileNotFoundError(
                f"{path} is an Orbax checkpoint of the JAX package, which this "
                f"package reads through a reference-style export beside it "
                f"({REFERENCE_EXPORT}); write it where the JAX package is "
                f"installed with:\n  {EXPORT_RECIPE}")
    meta = read_meta(path)
    preset = model_preset or meta.get("model_preset", "t5_small")
    task = task or meta.get("task", "mt3_full_plus")
    if audio_cfg is None:
        a = meta.get("audio", {})
        audio_cfg = AudioConfig(**a) if a else AudioConfig()
    model_cfg = None
    if model_preset is None and meta.get("model"):
        model_cfg = config_from_meta(meta["model"])
    bundle = init_model(preset, task, audio_cfg, model_cfg=model_cfg,
                        device=device, **cfg_overrides)
    if orbax:
        from .import_reference import import_checkpoint
        import_checkpoint(export, bundle.model, verbose=False,
                          require_complete=True)
    else:
        state = torch.load(params_path, map_location=bundle.device,
                           weights_only=True)
        bundle.model.load_state_dict(state, strict=True)
    return bundle


def restore_opt_state(path: str, device=None) -> Optional[dict]:
    """→ {"step", "opt_state"} or None when the checkpoint has none."""
    opt_path = os.path.join(os.path.abspath(path), OPT_NAME)
    if not os.path.exists(opt_path):
        return None
    return torch.load(opt_path, map_location=device, weights_only=True)
