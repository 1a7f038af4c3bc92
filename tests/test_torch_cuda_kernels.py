"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA device and skip without one. The file imports
nothing of JAX, so on a machine without it run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from yourmt3_tpu_torch.ops import decode_attention as da
from yourmt3_tpu_torch.ops import int4_cross_attention as ia
from yourmt3_tpu_torch.ops.kv_quant import quantize_kv, quantize_kv4_crosspack

pytestmark = pytest.mark.cuda

S, H, DK, BLOCK, NB, BUCKETS, MAXD = 8, 6, 64, 128, 8, 32, 128
L = NB * BLOCK
# both sides accumulate in fp32, in another order
TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pages(kind, gen, dev):
    out = {}
    for n in "kv":
        x = torch.randn(NB, S, H, BLOCK, DK, generator=gen)
        if kind == "int8":
            vals, sc = quantize_kv(x)
            out[n] = vals.to(dev)
            out[n + "_scale"] = sc.permute(1, 0, 2, 3).contiguous().to(dev)
        else:
            out[n] = x.to(torch.bfloat16 if kind == "bf16" else torch.float32).to(dev)
    return out


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16], ids=["q32", "q16"])
@pytest.mark.parametrize("kind,bias", [("int8", "table"), ("bf16", "table"),
                                       ("bf16", "row"), ("fp32", "none")])
def test_paged_decode_attention_matches_plain(dev, kind, bias, qdt):
    gen = torch.Generator().manual_seed(0)
    pages = _pages(kind, gen, dev)
    q = torch.randn(S, H, DK, generator=gen).to(dev, qdt)
    kw = {}
    if bias == "table":
        kw["rel_table"] = torch.randn(BUCKETS, H, generator=gen).to(dev)
    elif bias == "row":
        kw["bias_row"] = torch.randn(H, L, generator=gen).to(dev)
    if kind == "int8":
        kw.update(k_scale=pages["k_scale"], v_scale=pages["v_scale"])
    for pos in (0, BLOCK - 1, BLOCK, L - 1):
        before = da.paged_decode_attention.launches
        got = da.paged_decode_attention(q, pages["k"], pages["v"], pos,
                                        rel_max_distance=MAXD, **kw)
        assert da.paged_decode_attention.launches == before + 1
        want = da.paged_decode_attention_plain(q, pages["k"], pages["v"], pos,
                                               rel_max_distance=MAXD, **kw)
        torch.cuda.synchronize()
        assert got.dtype == qdt and got.shape == (S, H, DK)
        err = (got.float() - want.float()).abs().max().item()
        assert err < TOL[qdt], (pos, err)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    gen = torch.Generator().manual_seed(1)
    pages = _pages("bf16", gen, dev)
    q = torch.randn(S, H, DK, generator=gen).to(dev)
    before = da.paged_decode_attention.launches
    with pytest.raises(ValueError, match="contiguous"):
        da.paged_decode_attention(q, pages["k"].transpose(3, 4).contiguous()
                                  .transpose(3, 4), pages["v"], 0)
    with pytest.raises(TypeError):
        da.paged_decode_attention(q.double(), pages["k"], pages["v"], 0)
    with pytest.raises(ValueError, match="outside"):
        da.paged_decode_attention(q, pages["k"], pages["v"], L)
    with pytest.raises(ValueError, match="q on"):
        da.paged_decode_attention(q, pages["k"].cpu(), pages["v"], 0)
    assert da.paged_decode_attention.launches == before


def _int4_inputs(S, H, T, dk, gen, dev):
    out = []
    for _ in "kv":
        packed, scale = quantize_kv4_crosspack(torch.randn(S, H, T, dk, generator=gen))
        out += [packed.to(dev), scale.to(dev)]
    return out  # k4, ks, v4, vs


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16], ids=["q32", "q16"])
@pytest.mark.parametrize("S,H,T,dk", [(8, 6, 256, 64), (104, 6, 256, 64),
                                      (4, 2, 128, 32), (3, 4, 200, 16),
                                      (2, 2, 1000, 128)])
def test_int4_cross_attention_matches_plain(dev, S, H, T, dk, qdt):
    gen = torch.Generator().manual_seed(S + T + dk)
    k4, ks, v4, vs = _int4_inputs(S, H, T, dk, gen, dev)
    q = torch.randn(S, H, dk, generator=gen).to(dev, qdt)
    before = ia.int4_cross_attention.launches
    got = ia.int4_cross_attention(q, k4, ks, v4, vs)
    assert ia.int4_cross_attention.launches == before + 1
    want = ia.int4_cross_attention_plain(q, k4, ks, v4, vs)
    torch.cuda.synchronize()
    assert got.dtype == qdt and got.shape == (S, H, dk)
    err = (got.float() - want.float()).abs().max().item()
    assert err < TOL[qdt], err


def test_int4_wrapper_rejects_what_the_kernel_does_not_take(dev):
    gen = torch.Generator().manual_seed(2)
    k4, ks, v4, vs = _int4_inputs(2, 2, 64, 32, gen, dev)
    q = torch.randn(2, 2, 32, generator=gen).to(dev)
    before = ia.int4_cross_attention.launches
    with pytest.raises(TypeError):
        ia.int4_cross_attention(q.double(), k4, ks, v4, vs)
    with pytest.raises(ValueError, match="shape"):
        ia.int4_cross_attention(q[:, :1].contiguous(), k4, ks, v4, vs)
    with pytest.raises(ValueError, match="q on"):
        ia.int4_cross_attention(q, k4.cpu(), ks, v4, vs)
    with pytest.raises(ValueError, match="dk"):
        ia.int4_cross_attention(q[..., :24].contiguous(), k4, ks, v4, vs)
    assert ia.int4_cross_attention.launches == before
