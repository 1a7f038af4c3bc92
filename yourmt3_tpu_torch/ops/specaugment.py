"""SpecAugment on device: time and frequency masking over (B, T, F)
features, drawn from a torch.Generator on the features' device.

Each example gets `num_time_masks` time spans of width uniform in
[0, time_mask_width] and `num_freq_masks` frequency spans likewise, each
starting uniformly in [0, length - width) (at 0 when the width fills the
axis); masked cells take the example's mean, zero or minimum. The draws
cannot equal the reference's (another generator), only their
distribution.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    num_time_masks: int = 2
    time_mask_width: int = 32  # frames (of 256)
    num_freq_masks: int = 2
    freq_mask_width: int = 48  # bins
    mask_value: str = "mean"  # "mean" | "zero" | "min"


def _axis_mask(gen: Optional[torch.Generator], length: int, max_width: int,
               batch: int, n_masks: int, device) -> torch.Tensor:
    """(B, length) bool: True where masked."""
    widths = torch.randint(0, max_width + 1, (batch, n_masks, 1),
                           generator=gen, device=device)
    span = torch.clamp(length - widths, min=1)
    starts = torch.minimum(
        (torch.rand((batch, n_masks, 1), generator=gen, device=device)
         * span).long(), span - 1)
    pos = torch.arange(length, device=device)[None, None, :]
    return ((pos >= starts) & (pos < starts + widths)).any(dim=1)


def spec_augment(gen: Optional[torch.Generator], feats: torch.Tensor,
                 cfg: SpecAugmentConfig = SpecAugmentConfig()) -> torch.Tensor:
    """(B, T, F) → masked (B, T, F). Apply only in training."""
    B, T, F = feats.shape
    tmask = _axis_mask(gen, T, cfg.time_mask_width, B, cfg.num_time_masks,
                       feats.device)
    fmask = _axis_mask(gen, F, cfg.freq_mask_width, B, cfg.num_freq_masks,
                       feats.device)
    mask = tmask[:, :, None] | fmask[:, None, :]
    if cfg.mask_value == "zero":
        fill = torch.zeros((B, 1, 1), dtype=feats.dtype, device=feats.device)
    elif cfg.mask_value == "min":
        fill = feats.amin(dim=(1, 2), keepdim=True)
    else:
        fill = feats.mean(dim=(1, 2), keepdim=True)
    return torch.where(mask, fill, feats)


def make_augment_fn(cfg: Optional[SpecAugmentConfig] = None):
    """→ augment(gen, feats)."""
    return functools.partial(spec_augment, cfg=cfg or SpecAugmentConfig())
