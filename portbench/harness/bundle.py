"""The model under test, built from a configuration file and filled with
the seed's weights on its device.

The bundle is the program's own `api.ModelBundle` (model, log-mel
frontend, task manager, audio config), built as `api.init_model` builds
it, except that the weights come from harness/weights.py, drawn on the
device, and reach the model through `load_state_dict(strict=True)`, so
the int8 side-cars of the decoder follow the masters.
"""

from __future__ import annotations

from typing import Optional

from . import weights


def build(config: dict, device, seed: int, mode: Optional[str] = None,
          overrides: Optional[dict] = None):
    """The bundle of a configuration file; `mode` ("serve") applies that
    section's decode settings, `overrides` any ModelConfig fields."""
    import torch
    from yourmt3_tpu_torch.api import ModelBundle
    from yourmt3_tpu_torch.config.audio import AudioConfig
    from yourmt3_tpu_torch.config.model import ModelConfig
    from yourmt3_tpu_torch.models.ymt3 import YMT3
    from yourmt3_tpu_torch.ops.frontend import SpectrogramFrontend
    from yourmt3_tpu_torch.tokens.task_manager import TaskManager

    audio_cfg = AudioConfig(**config["audio"])
    tm = TaskManager(config["task"], audio_cfg)
    fields = {**config["model"], **(config[mode] if mode else {}), **(overrides or {})}
    cfg = ModelConfig(**fields)
    with torch.device(device):
        model = YMT3(cfg, audio_cfg.num_feature_bins)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    state = weights.for_config(config, shapes, seed, device, fields)
    model.load_state_dict(state, strict=True)
    del state
    frontend = SpectrogramFrontend(audio_cfg).to(device)
    return ModelBundle(model.eval(), frontend, tm, audio_cfg)
