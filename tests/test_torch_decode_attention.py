"""The port's paged decode attention (plain version; the CUDA kernel is
held against it on the card by chip_smoke.py), the paged-cache helpers,
int8 KV quantisation and the T5 buckets, against the JAX package.

The JAX Pallas kernel runs in interpret mode on the CPU, as its own tests
run it."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yourmt3_tpu.models.layers import relative_position_bucket as jax_bucket
from yourmt3_tpu.ops import kv_quant as jkv
from yourmt3_tpu.ops.pallas import decode_attention as jda
from yourmt3_tpu_torch.models.kv_cache import device_position
from yourmt3_tpu_torch.models.layers import relative_position_bucket
from yourmt3_tpu_torch.ops import decode_attention as pda
from yourmt3_tpu_torch.ops.kv_quant import (dequantize_kv,
                                            int8_decode_attention, quantize_kv)

S, H, DK, NB = 2, 3, 32, 2
BUCKETS, MAXD = 32, 128


def _inputs(block, quantized, seed):
    rng = np.random.default_rng(seed)
    L = NB * block
    d = dict(q=rng.standard_normal((S, H, DK)).astype(np.float32),
             table=rng.standard_normal((BUCKETS, H)).astype(np.float32),
             row=rng.standard_normal((H, L)).astype(np.float32))
    if quantized:  # int8 rows of N(0, 1) data with per-row scales
        for n in "kv":
            x = rng.standard_normal((NB, S, H, block, DK)).astype(np.float32)
            sc = np.abs(x).max(-1) / np.float32(127.0)
            d[n] = np.round(x / sc[..., None]).astype(np.int8)
            d[n + "s"] = np.ascontiguousarray(sc.transpose(1, 0, 2, 3))
    else:
        for n in "kv":
            d[n] = rng.standard_normal((NB, S, H, block, DK)).astype(np.float32)
    return d


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("bias", ["table", "row", "none"])
@pytest.mark.parametrize("block", [64, 128])
def test_plain_matches_jax_kernel(block, bias, quantized):
    d = _inputs(block, quantized, seed=block + len(bias))
    L = NB * block
    jax_kernel = jax.jit(functools.partial(
        jda.paged_decode_attention, block=block, streams_per_tile=S,
        interpret=True, rel_max_distance=MAXD))
    for pos in (0, block - 1, block, L - 1):
        jkw, pkw = {}, {}
        if bias == "table":
            jkw["rel_table"] = jnp.asarray(d["table"])
            pkw["rel_table"] = torch.from_numpy(d["table"])
        elif bias == "row":
            jkw["bias_row"] = jnp.asarray(d["row"])
            pkw["bias_row"] = torch.from_numpy(d["row"])
        if quantized:
            jkw.update(k_scale=jnp.asarray(d["ks"]), v_scale=jnp.asarray(d["vs"]))
            pkw.update(k_scale=torch.from_numpy(d["ks"]),
                       v_scale=torch.from_numpy(d["vs"]))
        want = jax_kernel(jnp.asarray(d["q"]), jnp.asarray(d["k"]),
                          jnp.asarray(d["v"]), jnp.asarray(pos, jnp.int32), **jkw)
        q = torch.from_numpy(d["q"])
        k, v = torch.from_numpy(d["k"]), torch.from_numpy(d["v"])
        got = pda.paged_decode_attention_plain(q, k, v, pos,
                                               rel_max_distance=MAXD, **pkw)
        err = np.abs(got.numpy() - np.asarray(want)).max()
        assert err < 1e-5, (pos, err)
        # the wrapper takes the plain version for CPU tensors, with 4-D q
        out4 = pda.paged_decode_attention(q[:, :, None], k, v, pos,
                                          rel_max_distance=MAXD, **pkw)
        assert torch.equal(out4[:, :, 0], got)


def test_wrapper_counts_no_launch_on_cpu_and_checks_arguments():
    d = _inputs(64, True, seed=0)
    q, k, v = (torch.from_numpy(d[n]) for n in "qkv")
    ks, vs = torch.from_numpy(d["ks"]), torch.from_numpy(d["vs"])
    before = pda.paged_decode_attention.launches
    pda.paged_decode_attention(q, k, v, 5, k_scale=ks, v_scale=vs)
    assert pda.paged_decode_attention.launches == before
    with pytest.raises(ValueError):
        pda.paged_decode_attention(q, k, v, 5, k_scale=ks)
    with pytest.raises(ValueError):
        pda.paged_decode_attention(q, k, v, 5, bias_row=torch.zeros(H, 192),
                                   rel_table=torch.zeros(BUCKETS, H))


def test_cross_attention_and_dense_reference_match_jax():
    rng = np.random.default_rng(3)
    T, blk = 48, 16
    q = rng.standard_normal((S, H, DK)).astype(np.float32)
    k = rng.standard_normal((S, H, T, DK)).astype(np.float32)
    v = rng.standard_normal((S, H, T, DK)).astype(np.float32)
    kp = pda.dense_to_paged(torch.from_numpy(k), blk)
    vp = pda.dense_to_paged(torch.from_numpy(v), blk)
    assert np.array_equal(kp.numpy(), np.asarray(jda.dense_to_paged(jnp.asarray(k), blk)))
    got = pda.paged_cross_attention(torch.from_numpy(q), kp, vp, T)
    want = jda.paged_cross_attention(jnp.asarray(q), jnp.asarray(kp.numpy()),
                                     jnp.asarray(vp.numpy()), T,
                                     streams_per_tile=S, interpret=True)
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5
    row = rng.standard_normal((H, T)).astype(np.float32)
    for pos in (0, 20, T - 1):
        got = pda.reference_decode_attention(torch.from_numpy(q), kp, vp, pos,
                                             torch.from_numpy(row))
        want = jda.reference_decode_attention(jnp.asarray(q), jnp.asarray(kp.numpy()),
                                              jnp.asarray(vp.numpy()), pos,
                                              jnp.asarray(row))
        assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5


@pytest.mark.parametrize("position", ["int", "tensor"])
@pytest.mark.parametrize("block", [64, 128])
def test_cache_helpers_match_jax_exactly(block, position):
    """The paged cache and scale writes at the edges of the pages, at the
    slot of a host int turned into the device position by the model's
    `device_position` or of a 0-dim tensor (a graphed step's device
    position): an index put, no host read, and the same bytes as JAX's
    writes."""
    rng = np.random.default_rng(block)
    L = NB * block
    cache = pda.empty_paged_cache(S, H, DK, L, block, torch.float32)
    scales = pda.empty_paged_scales(S, H, L, block)
    jcache = jda.empty_paged_cache(S, H, DK, L, block, jnp.float32)
    jscales = jda.empty_paged_scales(S, H, L, block)
    for pos in (0, block - 1, block, L - 1):
        step = rng.standard_normal((S, H, 1, DK)).astype(np.float32)
        sc = rng.standard_normal((S, H, 1)).astype(np.float32)
        at = pda.paged_slot(device_position(pos, "cpu") if position == "int"
                            else torch.tensor(pos), block)
        out = pda.paged_cache_update(cache, torch.from_numpy(step), at)
        assert out is cache  # in place
        pda.paged_scale_update(scales, torch.from_numpy(sc), at)
        jcache = jda.paged_cache_update(jcache, jnp.asarray(step), jnp.asarray(pos))
        jscales = jda.paged_scale_update(jscales, jnp.asarray(sc), jnp.asarray(pos))
        assert np.array_equal(cache.numpy(), np.asarray(jcache))
        assert np.array_equal(scales.numpy(), np.asarray(jscales))
    assert np.array_equal(pda.paged_to_dense(cache).numpy(),
                          np.asarray(jda.paged_to_dense(jcache)))
    dense = rng.standard_normal((S, H, L - 5, DK)).astype(np.float32)
    assert np.array_equal(pda.dense_to_paged(torch.from_numpy(dense), block).numpy(),
                          np.asarray(jda.dense_to_paged(jnp.asarray(dense), block)))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.0])
def test_quantize_kv_bit_exact(scale):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 3, 9, 64)) * scale).astype(np.float32)
    # exact half-way cases: round half to even on both sides
    x[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]
    x[0, 0, 1, :3] = [2.54, 0.01, -0.01]  # scale 0.02: 0.01/0.02 = 0.5
    x[0, 0, 1, 3:] = 0.0
    q, s = quantize_kv(torch.from_numpy(x))
    jq, js = jkv.quantize_kv(jnp.asarray(x))
    assert q.dtype == torch.int8
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(dequantize_kv(q, s).numpy(),
                          np.asarray(jkv.dequantize_kv(jq, js)))
    zq, zs = quantize_kv(torch.zeros(2, 5))  # all-zero rows stay zero
    assert not zq.any() and not zs.any()


def test_int8_decode_attention_matches_jax():
    rng = np.random.default_rng(11)
    Lk = 40
    q = rng.standard_normal((S, H, 1, DK)).astype(np.float32)
    kq, ks = jkv.quantize_kv(jnp.asarray(rng.standard_normal((S, H, Lk, DK)), jnp.float32))
    vq, vs = jkv.quantize_kv(jnp.asarray(rng.standard_normal((S, H, Lk, DK)), jnp.float32))
    bias = rng.standard_normal((1, H, 1, Lk)).astype(np.float32)
    for b in (bias, None):
        want = jkv.int8_decode_attention(jnp.asarray(q), kq, ks, vq, vs,
                                         None if b is None else jnp.asarray(b))
        got = int8_decode_attention(
            torch.from_numpy(q), *(torch.from_numpy(np.array(t)) for t in (kq, ks, vq, vs)),
            None if b is None else torch.from_numpy(b))
        assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-5


@pytest.mark.parametrize("bidirectional", [False, True])
def test_relative_position_bucket_exact(bidirectional):
    rel = np.arange(-2048, 2048, dtype=np.int32)
    got = relative_position_bucket(torch.from_numpy(rel), bidirectional,
                                   BUCKETS, MAXD).numpy()
    want = np.asarray(jax_bucket(jnp.asarray(rel), bidirectional, BUCKETS, MAXD))
    assert np.array_equal(got, want)


def test_distance_buckets_cover_every_distance():
    """The kernel's table: bucket of distance d for d <= max_distance, and
    the last bucket for every larger distance."""
    tab = pda.distance_buckets(BUCKETS, MAXD).numpy()
    d = np.arange(0, 4096, dtype=np.int32)
    want = np.asarray(jax_bucket(jnp.asarray(-d), False, BUCKETS, MAXD))
    via_table = np.where(d < len(tab), tab[np.minimum(d, len(tab) - 1)], BUCKETS - 1)
    assert np.array_equal(via_table, want)
