"""Convolutional pre-encoder: spectrogram → downsampled spectral tokens.

Three residual blocks, each a stride-(1, 2) 3x3 convolution that halves
the frequency axis followed by two 3x3 convolutions and a residual, all
with bias and tanh-gelu. The module takes and returns the reference's
layout ((B, T, F) in, (B, T, F/8, C) out) and runs NCHW inside, with
time on H and frequency on W.

Padding is the reference's "SAME": at stride 2 over an even axis the
whole padding (one column) goes after the axis, not half on each side.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ACTIVATIONS

gelu = ACTIVATIONS["gelu"]


def same_padding(size: int, kernel: int, stride: int):
    """(before, after) padding of flax/XLA "SAME" along one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """3x3 convolution with "SAME" padding, computed in `dtype`."""

    def __init__(self, in_ch: int, out_ch: int, stride=(1, 1),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__(in_ch, out_ch, 3, stride=stride, padding=0)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (sh, sw), (kh, kw) = self.stride, self.kernel_size
        pt, pb = same_padding(x.shape[2], kh, sh)
        pl, pr = same_padding(x.shape[3], kw, sw)
        x = F.pad(x.to(self.dtype), (pl, pr, pt, pb))
        return F.conv2d(x, self.weight.to(self.dtype),
                        self.bias.to(self.dtype), self.stride)


class ResConvBlock(nn.Module):
    def __init__(self, in_ch: int, channels: int, freq_stride: int = 2,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv_down = Conv2dSame(in_ch, channels, (1, freq_stride), dtype)
        self.conv_a = Conv2dSame(channels, channels, dtype=dtype)
        self.conv_b = Conv2dSame(channels, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C_in, T, F) → (B, channels, T, F / stride)."""
        h = gelu(self.conv_down(x))
        r = h
        h = gelu(self.conv_a(h))
        h = self.conv_b(h)
        return gelu(h + r)


class ConvPreEncoder(nn.Module):
    """(B, T, F) → (B, T, F / 2**num_blocks, channels)."""

    def __init__(self, channels: int = 128, num_blocks: int = 3,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.block = nn.ModuleList(
            [ResConvBlock(1 if i == 0 else channels, channels, 2, dtype)
             for i in range(num_blocks)])

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        x = feats[:, None].to(self.dtype)  # (B, 1, T, F)
        for blk in self.block:
            x = blk(x)
        return x.permute(0, 2, 3, 1)
