"""Dropout and SpecAugment masks under data parallelism do not depend on
the number of ranks, as the JAX package's do not (its step draws one key's
masks for the whole global batch under jit): each rank draws the masks of
the global batch from a generator in the same state and keeps its rows
(`shard` = (rank, world)), so the ranks' outputs, stacked, are one
process's. On a 2-D mesh the dropout mask is sliced on the feature axis
too (`tp`). The world-2 training step itself is held to one process in
tests/test_torch_parallel.py (its mask cases), on a 2-D mesh by
chip_smoke.py phase 10b."""

import types

import pytest
import torch

from yourmt3_tpu_torch.models.layers import Dropout
from yourmt3_tpu_torch.ops.specaugment import spec_augment


def _dropout(x, shard=(0, 1), tp=None, seed=0):
    d = Dropout(0.3).train()
    d.generator, d.shard = torch.Generator().manual_seed(seed), shard
    return d(x, tp)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("shape", [(8, 5, 6), (8, 6)])
def test_dropout_ranks_stack_to_one_process(world, shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1)) + 3.0
    whole = _dropout(x)
    n = shape[0] // world
    parts = [_dropout(x[r * n:(r + 1) * n], (r, world)) for r in range(world)]
    assert torch.equal(torch.cat(parts), whole)
    assert bool((whole == 0).any()) and bool((whole != 0).any())


def test_dropout_on_a_2d_mesh_keeps_rows_and_features():
    """(data, model) = (2, 2): each rank's mask is its rows and its feature
    slice of the one-process mask."""
    x = torch.randn((4, 3, 8), generator=torch.Generator().manual_seed(2)) + 3.0
    whole = _dropout(x)
    for r in range(2):
        for m in range(2):
            tp = types.SimpleNamespace(rank=m, size=2)
            part = _dropout(x[2 * r:2 * r + 2, :, 4 * m:4 * m + 4], (r, 2), tp)
            assert torch.equal(part, whole[2 * r:2 * r + 2, :, 4 * m:4 * m + 4])


def test_spec_augment_ranks_stack_to_one_process():
    feats = torch.randn((4, 64, 40), generator=torch.Generator().manual_seed(3))
    whole = spec_augment(torch.Generator().manual_seed(0), feats)
    parts = [spec_augment(torch.Generator().manual_seed(0), feats[2 * r:2 * r + 2],
                          shard=(r, 2)) for r in range(2)]
    assert torch.equal(torch.cat(parts), whole)
    assert not torch.equal(whole, feats)
