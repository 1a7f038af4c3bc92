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
POSITIONS = (0, BLOCK - 1, BLOCK, L - 1)


def _inputs(quantized, seed):
    rng = np.random.default_rng(seed)
    d = dict(q=rng.standard_normal((S, H, DK)).astype(np.float32),
             table=rng.standard_normal((BUCKETS, H)).astype(np.float32),
             row=rng.standard_normal((H, L)).astype(np.float32))
    for n in "kv":
        x = rng.standard_normal((NB, S, H, BLOCK, DK)).astype(np.float32)
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
def _jax_outputs(bias, quantized):
    """The JAX kernel's output at each position (one jit per mode)."""
    d = _inputs(quantized, seed=len(bias) + 10 * quantized)
    jkw, _ = _kwargs(d, bias, quantized)
    kernel = jax.jit(functools.partial(
        jda.paged_decode_attention, block=BLOCK, streams_per_tile=S,
        interpret=True, rel_max_distance=MAXD))
    return {pos: np.asarray(kernel(jnp.asarray(d["q"]), jnp.asarray(d["k"]),
                                   jnp.asarray(d["v"]), jnp.asarray(pos, jnp.int32),
                                   **jkw))
            for pos in POSITIONS}


@pytest.mark.parametrize("split_rows", [16, 64, 128, L])
@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("bias", ["table", "row", "none"])
def test_split_merge_matches_jax_kernel(bias, quantized, split_rows):
    """Every position, including ranges that lie wholly past pos (pos 0
    with 16-row ranges leaves 15 empty ones), within 1e-5 in fp32."""
    d = _inputs(quantized, seed=len(bias) + 10 * quantized)
    _, pkw = _kwargs(d, bias, quantized)
    q, k, v = (torch.from_numpy(d[n]) for n in "qkv")
    for pos, want in _jax_outputs(bias, quantized).items():
        got = pda.paged_decode_attention_split_plain(
            q, k, v, pos, split_rows, rel_max_distance=MAXD, **pkw)
        assert got.dtype == torch.float32 and got.shape == (S, H, DK)
        err = np.abs(got.numpy() - want).max()
        assert err < 1e-5, (pos, err)
        plain = pda.paged_decode_attention_plain(q, k, v, pos, rel_max_distance=MAXD, **pkw)
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
