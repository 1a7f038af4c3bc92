"""The port's int4 K/V quantisation and the int4 cross-attention's plain
version (the CUDA kernel is held against it on the card by
chip_smoke.py and tests/test_torch_cuda_kernels.py) against the JAX
package. The JAX Pallas kernel runs in interpret mode on the CPU, as its
own tests run it."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yourmt3_tpu.ops import kv_quant as jkv
from yourmt3_tpu.ops.pallas import decode_attention as jda
from yourmt3_tpu_torch.ops import int4_cross_attention as pia
from yourmt3_tpu_torch.ops import kv_quant as pkv

# fp32 q: both sides accumulate in fp32, in another order
TOL_FP32 = 1e-4
# bf16 q: the outputs round the same fp32 value to bf16; a value next to a
# rounding boundary may round one bf16 ulp apart (2^-6 for |x| in [2, 4))
TOL_BF16 = 1.6e-2
TOL = {np.float32: TOL_FP32, jnp.bfloat16: TOL_BF16}


def _rows(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    # exact half-way cases (round half to even), a zero row, a tie at ±7
    x[0, 0, 0, :4] = [7.0, 0.5, 1.5, -2.5]
    x[0, 0, 1, :] = 0.0
    x[0, 0, 2, :4] = [-3.5, 3.5, 0.25, -0.25]
    return x


@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.0])
def test_int4_packing_bit_exact(scale):
    x = _rows(int(scale * 1e3), (3, 2, 10, 16), scale)
    for port_fn, jax_fn in ((pkv.quantize_kv4, jkv.quantize_kv4),
                            (pkv.quantize_kv4_crosspack,
                             jkv.quantize_kv4_crosspack)):
        p, s = port_fn(torch.from_numpy(x))
        jp, js = jax_fn(jnp.asarray(x))
        assert p.dtype == torch.uint8 and p.is_contiguous()
        assert np.array_equal(p.numpy(), np.asarray(jp))
        assert np.array_equal(s.numpy(), np.asarray(js))
    p, s = pkv.quantize_kv4(torch.from_numpy(x))
    for got, want in zip(pkv.unpack_kv4(p), jkv.unpack_kv4(jnp.asarray(p.numpy()))):
        assert got.dtype == torch.bfloat16
        assert np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    p, s = pkv.quantize_kv4_crosspack(torch.from_numpy(x))
    assert p.shape == (3, 2, 8, 10)
    back = pkv.dequantize_kv4_crosspack(p, s)
    want = jkv.dequantize_kv4_crosspack(jnp.asarray(p.numpy()), jnp.asarray(s.numpy()))
    assert np.array_equal(back.numpy(), np.asarray(want))
    # within half an int4 step of the input
    assert (back - torch.from_numpy(x)).abs().le(s[..., None] * 0.51).all()


def _cross_inputs(S, H, T, dk, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, H, dk)).astype(np.float32)
    k = rng.standard_normal((S, H, T, dk)).astype(np.float32)
    v = rng.standard_normal((S, H, T, dk)).astype(np.float32)
    k4, ks = jkv.quantize_kv4_crosspack(jnp.asarray(k))
    v4, vs = jkv.quantize_kv4_crosspack(jnp.asarray(v))
    return q, [np.array(a) for a in (k4, ks, v4, vs)]


@pytest.mark.parametrize("qdt", [np.float32, jnp.bfloat16], ids=["q32", "q16"])
@pytest.mark.parametrize("S,H,T,dk", [(4, 2, 128, 32), (8, 6, 256, 64)])
def test_int4_cross_plain_matches_jax_kernel(S, H, T, dk, qdt):
    q, kv = _cross_inputs(S, H, T, dk, seed=S + T + dk)
    qj = jnp.asarray(q).astype(qdt)
    want = jax.jit(functools.partial(jda.int4_cross_attention, interpret=True))(
        qj, *(jnp.asarray(a) for a in kv))
    want = np.asarray(want, np.float32)
    qt = torch.from_numpy(np.array(qj, np.float32)).to(
        torch.bfloat16 if qdt is jnp.bfloat16 else torch.float32)
    tk = [torch.from_numpy(a) for a in kv]
    got = pia.int4_cross_attention_plain(qt, *tk)
    assert got.dtype == qt.dtype and got.shape == (S, H, dk)
    assert np.abs(want).max() < 4
    err = np.abs(got.float().numpy() - want).max()
    assert err < TOL[qdt], err
    # the wrapper takes the plain version for CPU tensors (no launch),
    # with q as (S, H, 1, dk) too
    before = pia.int4_cross_attention.launches
    out4 = pia.int4_cross_attention(qt[:, :, None], *tk)
    assert pia.int4_cross_attention.launches == before
    assert out4.shape == (S, H, 1, dk) and torch.equal(out4[:, :, 0], got)


def test_int4_cross_plain_is_exact_attention_over_dequantized_kv():
    """The nibble algebra is softmax(q·K)·V over the dequantized rows."""
    q, (k4, ks, v4, vs) = _cross_inputs(3, 2, 40, 16, seed=5)
    k = pkv.dequantize_kv4_crosspack(torch.from_numpy(k4), torch.from_numpy(ks))
    v = pkv.dequantize_kv4_crosspack(torch.from_numpy(v4), torch.from_numpy(vs))
    qt = torch.from_numpy(q).double()
    w = torch.softmax(torch.einsum("shd,shtd->sht", qt, k.double()), -1)
    want = torch.einsum("sht,shtd->shd", w, v.double())
    got = pia.int4_cross_attention_plain(
        torch.from_numpy(q), *(torch.from_numpy(a) for a in (k4, ks, v4, vs)))
    assert (got.double() - want).abs().max().item() < TOL_FP32


@pytest.mark.parametrize("qdt", [np.float32, jnp.bfloat16], ids=["q32", "q16"])
def test_int4_decode_attention_matches_jax(qdt):
    rng = np.random.default_rng(13)
    S, H, Lk, dk = 3, 2, 40, 32
    q = jnp.asarray(rng.standard_normal((S, H, 1, dk)), jnp.float32).astype(qdt)
    kp, ks = jkv.quantize_kv4(jnp.asarray(rng.standard_normal((S, H, Lk, dk)), jnp.float32))
    vp, vs = jkv.quantize_kv4(jnp.asarray(rng.standard_normal((S, H, Lk, dk)), jnp.float32))
    bias = rng.standard_normal((1, H, 1, Lk)).astype(np.float32)
    qt = torch.from_numpy(np.array(q, np.float32)).to(
        torch.bfloat16 if qdt is jnp.bfloat16 else torch.float32)
    for b in (bias, None):
        want = jkv.int4_decode_attention(q, kp, ks, vp, vs,
                                         None if b is None else jnp.asarray(b))
        got = pkv.int4_decode_attention(
            qt, *(torch.from_numpy(np.array(t)) for t in (kp, ks, vp, vs)),
            None if b is None else torch.from_numpy(b))
        assert got.dtype == qt.dtype
        err = np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()
        assert err < TOL[qdt], err
