"""The split-KV algebra of the port's paged decode kernel on the CPU: the
cache cut into ranges, each range's partial softmax state (max,
normaliser, unnormalised accumulator), the merge, against the JAX Pallas
kernel in interpret mode, as its own tests run it. The CUDA kernel is held
against the plain version on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yourmt3_tpu.ops.pallas import decode_attention as jda
from yourmt3_tpu_torch.ops import decode_attention as pda

S, H, DK, NB, BLOCK = 2, 3, 32, 4, 64
L = NB * BLOCK
BUCKETS, MAXD = 32, 128
# NB_LONG pages make the t5_small decode cache's 1024 rows, cut as the CUDA
# kernel cuts them: eight ranges of 128 at every position
NB_LONG = 16


def _positions(length):
    """Page edges, range edges and the last row of a cache of `length`."""
    return tuple(p for p in (0, BLOCK - 1, BLOCK, 127, 128, 511) if p < length) + (
        length - 1,)


def _inputs(quantized, seed, nb=NB):
    rng = np.random.default_rng(seed)
    d = dict(q=rng.standard_normal((S, H, DK)).astype(np.float32),
             table=rng.standard_normal((BUCKETS, H)).astype(np.float32),
             row=rng.standard_normal((H, nb * BLOCK)).astype(np.float32))
    for n in "kv":
        x = rng.standard_normal((nb, S, H, BLOCK, DK)).astype(np.float32)
        if quantized:  # int8 rows with per-row scales
            sc = np.abs(x).max(-1) / np.float32(127.0)
            d[n] = np.round(x / sc[..., None]).astype(np.int8)
            d[n + "s"] = np.ascontiguousarray(sc.transpose(1, 0, 2, 3))
        else:
            d[n] = x
    return d


def _kwargs(d, bias, quantized):
    jkw, pkw = {}, {}
    if bias == "table":
        jkw["rel_table"], pkw["rel_table"] = jnp.asarray(d["table"]), torch.from_numpy(d["table"])
    elif bias == "row":
        jkw["bias_row"], pkw["bias_row"] = jnp.asarray(d["row"]), torch.from_numpy(d["row"])
    if quantized:
        jkw.update(k_scale=jnp.asarray(d["ks"]), v_scale=jnp.asarray(d["vs"]))
        pkw.update(k_scale=torch.from_numpy(d["ks"]), v_scale=torch.from_numpy(d["vs"]))
    return jkw, pkw


@functools.lru_cache(maxsize=None)
def _jax_outputs(bias, quantized, nb):
    """The JAX kernel's output at each position (one jit per mode)."""
    d = _inputs(quantized, seed=len(bias) + 10 * quantized, nb=nb)
    jkw, _ = _kwargs(d, bias, quantized)
    kernel = jax.jit(functools.partial(
        jda.paged_decode_attention, block=BLOCK, streams_per_tile=S,
        interpret=True, rel_max_distance=MAXD))
    return {pos: np.asarray(kernel(jnp.asarray(d["q"]), jnp.asarray(d["k"]),
                                   jnp.asarray(d["v"]), jnp.asarray(pos, jnp.int32),
                                   **jkw))
            for pos in _positions(nb * BLOCK)}


@pytest.mark.parametrize("nb,split_rows", [(NB, 16), (NB, 64), (NB, 128), (NB, L),
                                           (NB_LONG, 128)],
                         ids=["16", "64", "128", str(L), "1024-128"])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("bias", ["table", "row", "none"])
def test_split_merge_matches_jax_kernel(bias, quantized, nb, split_rows):
    """Every position, including ranges that lie wholly past pos (pos 0
    with 16-row ranges leaves 15 empty ones; the 1024-row cache in ranges
    of 128, the kernel's grid, leaves up to seven), with the position as a
    host int and as a 0-dim tensor, within 1e-5 in fp32."""
    d = _inputs(quantized, seed=len(bias) + 10 * quantized, nb=nb)
    _, pkw = _kwargs(d, bias, quantized)
    q, k, v = (torch.from_numpy(d[n]) for n in "qkv")
    for pos, want in _jax_outputs(bias, quantized, nb).items():
        plain = pda.paged_decode_attention_plain(q, k, v, pos, rel_max_distance=MAXD, **pkw)
        for at in (pos, torch.tensor(pos)):
            got = pda.paged_decode_attention_split_plain(
                q, k, v, at, split_rows, rel_max_distance=MAXD, **pkw)
            assert got.dtype == torch.float32 and got.shape == (S, H, DK)
            err = np.abs(got.numpy() - want).max()
            assert err < 1e-5, (pos, type(at), err)
            assert (got - plain).abs().max().item() < 1e-5


def test_empty_range_weighs_nothing():
    """A range past pos merges with weight exp(-1e30 - m) = 0: no NaN, and
    the result equals the one range that holds the live rows."""
    d = _inputs(False, seed=3)
    q, k, v = (torch.from_numpy(d[n]) for n in "qkv")
    one = pda.paged_decode_attention_split_plain(q, k, v, 5, L)
    many = pda.paged_decode_attention_split_plain(q, k, v, 5, 16)
    assert torch.isfinite(many).all()
    assert (one - many).abs().max().item() < 1e-6
    q4 = q[:, :, None]  # the 4-D form keeps its shape
    assert pda.paged_decode_attention_split_plain(q4, k, v, 5, 64).shape == (S, H, 1, DK)
