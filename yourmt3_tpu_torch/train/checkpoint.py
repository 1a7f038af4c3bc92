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
dict rebuilds them from the restored masters.

Orbax checkpoints of the JAX package are not read here: restoring one
raises, naming ROADMAP Queue 1 item 13 (a converter).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import torch

META_NAME = "ymt3_meta.json"
PARAMS_NAME = "params.pt"
OPT_NAME = "opt_state.pt"


def _atomic_save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


def save_bundle(path: str, bundle, step: int = 0,
                opt_state: Optional[dict] = None) -> None:
    """Write the master weights (+ optional optimizer state) and metadata."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    _atomic_save(_to_cpu(bundle.model.state_dict()), os.path.join(path, PARAMS_NAME))
    if opt_state is not None:
        _atomic_save({"step": int(step), "opt_state": _to_cpu(opt_state)},
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


def restore_bundle(path: str, model_preset: Optional[str] = None,
                   task: Optional[str] = None, audio_cfg=None, device=None,
                   **cfg_overrides):
    """Rebuild the bundle a checkpoint was written from. cfg_overrides are
    inference-time ModelConfig fields (kv_quant, use_pallas_decode,
    weight_quant): they never change the parameters, so the restored
    weights apply unchanged and the side-car weights follow them."""
    from ..api import init_model
    from ..config.audio import AudioConfig
    from ..config.model import ModelConfig
    path = os.path.abspath(path)
    params_path = os.path.join(path, PARAMS_NAME)
    if not os.path.exists(params_path):
        if os.path.isdir(os.path.join(path, "params")):
            raise NotImplementedError(
                f"{path} is an Orbax checkpoint of the JAX package: converting "
                "it is not ported yet (ROADMAP Queue 1 item 13)")
        raise FileNotFoundError(f"no checkpoint in {path} (no {PARAMS_NAME})")
    meta = read_meta(path)
    preset = model_preset or meta.get("model_preset", "t5_small")
    task = task or meta.get("task", "mt3_full_plus")
    if audio_cfg is None:
        a = meta.get("audio", {})
        audio_cfg = AudioConfig(**a) if a else AudioConfig()
    model_cfg = None
    if model_preset is None and meta.get("model"):
        known = {f.name for f in dataclasses.fields(ModelConfig)}
        model_cfg = ModelConfig(**{k: v for k, v in meta["model"].items()
                                   if k in known})
    bundle = init_model(preset, task, audio_cfg, model_cfg=model_cfg,
                        device=device, **cfg_overrides)
    state = torch.load(params_path, map_location=bundle.device, weights_only=True)
    bundle.model.load_state_dict(state, strict=True)
    return bundle


def restore_opt_state(path: str, device=None) -> Optional[dict]:
    """→ {"step", "opt_state"} or None when the checkpoint has none."""
    opt_path = os.path.join(os.path.abspath(path), OPT_NAME)
    if not os.path.exists(opt_path):
        return None
    return torch.load(opt_path, map_location=device, weights_only=True)
