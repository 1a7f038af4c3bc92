"""SpecAugment on device: time and frequency masking over (B, T, F)
features, drawn from a torch.Generator on the features' device.

Each example gets `num_time_masks` time spans of width uniform in
[0, time_mask_width] and `num_freq_masks` frequency spans likewise, each
starting uniformly in [0, length - width) (at 0 when the width fills the
axis); masked cells take the example's mean, zero or minimum. The draws
cannot equal the reference's (another generator), only their
distribution. Under data parallelism each rank draws the masks of the
global batch and keeps its own rows (`shard`), so the masks do not depend
on the number of ranks, as the reference's do not.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    num_time_masks: int = 2
    time_mask_width: int = 32  # frames (of 256)
    num_freq_masks: int = 2
    freq_mask_width: int = 48  # bins
    mask_value: str = "mean"  # "mean" | "zero" | "min"


def _axis_mask(gen: Optional[torch.Generator], length: int, max_width: int,
               batch: int, n_masks: int, device,
               shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """(B, length) bool: True where masked; this rank's rows of the masks
    of a global batch of world · B rows (shard = (rank, world))."""
    rank, world = shard
    rows = batch * world
    widths = torch.randint(0, max_width + 1, (rows, n_masks, 1),
                           generator=gen, device=device)
    span = torch.clamp(length - widths, min=1)
    starts = torch.minimum(
        (torch.rand((rows, n_masks, 1), generator=gen, device=device)
         * span).long(), span - 1)
    widths, starts = (t.narrow(0, rank * batch, batch) for t in (widths, starts))
    pos = torch.arange(length, device=device)[None, None, :]
    return ((pos >= starts) & (pos < starts + widths)).any(dim=1)


def spec_augment(gen: Optional[torch.Generator], feats: torch.Tensor,
                 cfg: SpecAugmentConfig = SpecAugmentConfig(),
                 shard: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """(B, T, F) → masked (B, T, F). Apply only in training. shard =
    (rank, world) on the data axis: `feats` are this rank's rows of the
    global batch."""
    B, T, F = feats.shape
    tmask = _axis_mask(gen, T, cfg.time_mask_width, B, cfg.num_time_masks,
                       feats.device, shard)
    fmask = _axis_mask(gen, F, cfg.freq_mask_width, B, cfg.num_freq_masks,
                       feats.device, shard)
    mask = tmask[:, :, None] | fmask[:, None, :]
    if cfg.mask_value == "zero":
        fill = torch.zeros((B, 1, 1), dtype=feats.dtype, device=feats.device)
    elif cfg.mask_value == "min":
        fill = feats.amin(dim=(1, 2), keepdim=True)
    else:
        fill = feats.mean(dim=(1, 2), keepdim=True)
    return torch.where(mask, fill, feats)


def make_augment_fn(cfg: Optional[SpecAugmentConfig] = None):
    """→ augment(gen, feats, shard=(0, 1))."""
    return functools.partial(spec_augment, cfg=cfg or SpecAugmentConfig())
