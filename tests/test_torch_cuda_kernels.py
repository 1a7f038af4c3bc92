"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA device and skip without one. The file imports
nothing of JAX, so on a machine without it run it with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py
"""

import pytest
import torch

from yourmt3_tpu_torch.ops import decode_attention as da
from yourmt3_tpu_torch.ops import int4_cross_attention as ia
from yourmt3_tpu_torch.ops import kv_quant as kq
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


def _paged_case(S, dk, kind, gen, dev, nb=NB):
    """Pages, q and a table bias at S streams, width dk."""
    pages = {}
    for n in "kv":
        x = torch.randn(nb, S, H, BLOCK, dk, generator=gen)
        if kind == "int8":
            vals, sc = quantize_kv(x)
            pages[n] = vals.to(dev)
            pages[n + "_scale"] = sc.permute(1, 0, 2, 3).contiguous().to(dev)
        else:
            pages[n] = x.to(torch.bfloat16 if kind == "bf16" else torch.float32).to(dev)
    kw = dict(rel_table=torch.randn(BUCKETS, H, generator=gen).to(dev))
    if kind == "int8":
        kw.update(k_scale=pages["k_scale"], v_scale=pages["v_scale"])
    return pages, kw


# ranges of 128 rows over the whole cache at every S (S·H from 48 to 624)
# and every position; pos 0 and 63 leave seven ranges empty, pos 700 the
# sixth range partial; dk = 128 with bf16 pages
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16], ids=["q32", "q16"])
@pytest.mark.parametrize("S,dk,kind", [(8, 64, "int8"), (16, 64, "int8"), (32, 64, "int8"),
                                       (104, 64, "bf16"), (8, 128, "bf16"),
                                       (8, 16, "fp32")])
def test_paged_split_kv_matches_plain(dev, S, dk, kind, qdt):
    gen = torch.Generator().manual_seed(S + dk)
    pages, kw = _paged_case(S, dk, kind, gen, dev)
    q = torch.randn(S, H, dk, generator=gen).to(dev, qdt)
    splits, rows = da.decode_splits(L)
    assert (splits, rows) == (L // 128, 128)
    for pos in (0, 63, 64, 700, L - 1):
        before = da.paged_decode_attention.launches
        got = da.paged_decode_attention(q, pages["k"], pages["v"], pos,
                                        rel_max_distance=MAXD, **kw)
        assert da.paged_decode_attention.launches == before + 1
        want = da.paged_decode_attention_plain(q, pages["k"], pages["v"], pos,
                                               rel_max_distance=MAXD, **kw)
        torch.cuda.synchronize()
        assert got.dtype == qdt and got.shape == (S, H, dk)
        err = (got.float() - want.float()).abs().max().item()
        assert err < TOL[qdt], (pos, splits, err)


@pytest.mark.parametrize("pos", [127, 511, 1023])
def test_paged_output_does_not_depend_on_the_batch(dev, pos):
    """A stream's output is bit-identical whether it is decoded alone or
    among 8, 16 or 48 streams (the rows of a compacted batch, gathered
    from the full one)."""
    gen = torch.Generator().manual_seed(pos)
    full = 48
    pages, kw = _paged_case(full, DK, "int8", gen, dev)
    q = torch.randn(full, H, DK, generator=gen).to(dev, torch.bfloat16)
    want = da.paged_decode_attention(q, pages["k"], pages["v"], pos,
                                     rel_max_distance=MAXD, **kw)
    for kept in (1, 8, 16):
        idx = torch.randperm(full, generator=gen)[:kept].sort().values.to(dev)
        got = da.paged_decode_attention(
            q[idx], pages["k"][:, idx].contiguous(), pages["v"][:, idx].contiguous(),
            pos, rel_max_distance=MAXD, rel_table=kw["rel_table"],
            k_scale=kw["k_scale"][idx].contiguous(),
            v_scale=kw["v_scale"][idx].contiguous())
        torch.cuda.synchronize()
        assert torch.equal(got, want[idx]), (pos, kept)


def test_decode_splits_do_not_depend_on_the_stream_count(dev):
    """The operator's split takes the cache length alone (no stream or
    head count, no position): ranges of 128 rows, one below 128."""
    for length in (16, 64, 128, 256, 1024, 4096):
        assert da.decode_splits(length) == (-(-length // 128), min(length, 128)), length


POSITIONS = (0, 127, 128, 511, 1023)


@pytest.mark.parametrize("kind", ["int8", "bf16"])
@pytest.mark.parametrize("streams", [8, 16])
def test_device_position_matches_host_position(dev, streams, kind):
    """The position as a 0-dim tensor on the card, read by the kernel,
    against the host position: bit for bit. And both against the grid a
    host position used to pick, the ranges up to the last live one (the
    cache cut to its live pages): the empty ranges past pos weigh exactly
    nothing."""
    gen = torch.Generator().manual_seed(streams + len(kind))
    pages, kw = _paged_case(streams, DK, kind, gen, dev)
    q = torch.randn(streams, H, DK, generator=gen).to(dev, torch.bfloat16)
    for pos in POSITIONS:
        host = da.paged_decode_attention(q, pages["k"], pages["v"], pos,
                                         rel_max_distance=MAXD, **kw)
        on_card = torch.tensor(pos, device=dev)
        got = da.paged_decode_attention(q, pages["k"], pages["v"], on_card,
                                        rel_max_distance=MAXD, **kw)
        live = pos // BLOCK + 1  # pages holding rows 0 .. pos
        cut = {n: v[:, :live].contiguous() for n, v in kw.items() if n.endswith("scale")}
        old = da.paged_decode_attention(
            q, pages["k"][:live], pages["v"][:live], pos, rel_max_distance=MAXD,
            rel_table=kw["rel_table"], **cut)
        want = da.paged_decode_attention_plain(q, pages["k"], pages["v"], pos,
                                               rel_max_distance=MAXD, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, host), pos
        assert torch.equal(got, old), pos
        err = (got.float() - want.float()).abs().max().item()
        assert err < TOL[torch.bfloat16], (pos, err)


def test_paged_op_replays_in_a_cuda_graph(dev):
    """Captured once with the position in a tensor on the card (output,
    split workspace and merge inside the graph), replayed at five
    positions by rewriting that tensor: the eager result at each."""
    gen = torch.Generator().manual_seed(7)
    pages, kw = _paged_case(S, DK, "int8", gen, dev)
    kw["dist_buckets"] = da.distance_buckets(BUCKETS, MAXD, dev)
    q = torch.randn(S, H, DK, generator=gen).to(dev, torch.bfloat16)
    assert da.decode_splits(L)[0] > 1
    eager = {p: da.paged_decode_attention(q, pages["k"], pages["v"], p, **kw)
             for p in POSITIONS}
    pos = torch.tensor(0, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.paged_decode_attention(q, pages["k"], pages["v"], pos, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.paged_decode_attention(q, pages["k"], pages["v"], pos, **kw)
    for p in POSITIONS + POSITIONS[::-1]:
        pos.fill_(p)
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager[p]), p


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
    with pytest.raises(ValueError, match="0-dim int64"):
        da.paged_decode_attention(q, pages["k"], pages["v"],
                                  torch.tensor(0.0, device=dev))
    with pytest.raises(ValueError, match="q on"):
        da.paged_decode_attention(q, pages["k"].cpu(), pages["v"], 0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        da.paged_decode_attention(q, pages["k"], pages["v"], 0,
                                  bias_row=torch.zeros(H, L, device=dev),
                                  rel_table=torch.zeros(BUCKETS, H, device=dev))
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


@pytest.mark.parametrize("dk", [16, 32, 64, 128])
@pytest.mark.parametrize("S,T", [(104, 256), (24, 4096)], ids=["one-chunk", "16-chunks"])
def test_int4_cross_attention_at_full_occupancy(dev, S, T, dk):
    """Many CTAs on each SM at every width (a copy that lands late shows
    here, not at S = 8), and T walked in 16 double-buffered chunks."""
    gen = torch.Generator().manual_seed(S + T + dk)
    k4, ks, v4, vs = _int4_inputs(S, 6, T, dk, gen, dev)
    q = torch.randn(S, 6, dk, generator=gen).to(dev)
    got = ia.int4_cross_attention(q, k4, ks, v4, vs)
    want = ia.int4_cross_attention_plain(q, k4, ks, v4, vs)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err < TOL[torch.float32], err


def _replays_in_a_graph(fn):
    """fn() captured once in a CUDA graph and replayed three times: each
    replay gives the eager result, bit for bit."""
    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_int4_op_replays_in_a_cuda_graph(dev):
    gen = torch.Generator().manual_seed(8)
    k4, ks, v4, vs = _int4_inputs(104, 6, 256, 64, gen, dev)
    q = torch.randn(104, 6, 64, generator=gen).to(dev, torch.bfloat16)
    _replays_in_a_graph(lambda: ia.int4_cross_attention(q, k4, ks, v4, vs))


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


# ---------------------------------------------------------------------------
# dense int8 decode attention

def _int8_case(S, Hkv, M, L, dk, n, pos, bias, gen, dev):
    """Whole int8 caches of N(0, 1) rows (S, Hkv, L, dk), q (S, Hkv, M, dk)
    and, with `bias`, the decoder's step bias (1, Hkv, M, n): a relative
    bias gathered and transposed as `kv_cache.step_bias` gathers it (so
    not contiguous), -1e9 past pos."""
    kq_, ks = quantize_kv(torch.randn(S, Hkv, L, dk, generator=gen))
    vq, vs = quantize_kv(torch.randn(S, Hkv, L, dk, generator=gen))
    q = torch.randn(S, Hkv, M, dk, generator=gen)
    b = None
    if bias:
        rel = torch.randn(n, Hkv * M, generator=gen).T.reshape(1, Hkv, M, n)
        j = torch.arange(n)
        b = rel + torch.where(j > (n - 1 if pos is None else pos), -1e9, 0.0)
        b = b.to(dev)
    return [t.to(dev) for t in (q, kq_, ks, vq, vs)] + [b]


def _int8_err_bounds(vq, vs, want, qdt):
    """(max, mean) |kernel - plain|. Both round each softmax weight w·vs to
    bf16 after summing the exponentials in another order, so a weight may
    round one bf16 ulp (2^-7 of it) apart; the weights sum to one, so the
    output moves by at most 2^-7 · max |v · vs|. A bf16 output rounds the
    same fp32 value, one ulp apart at a boundary. Such flips are rare: the
    mean error stays at the fp32 summation order's."""
    vmax = (vq.float() * vs[..., None]).abs().max().item()
    out_ulp = 2.0 ** -7 * want.float().abs().max().item() if qdt == torch.bfloat16 else 0.0
    return 2.0 ** -7 * vmax + out_ulp + 1e-5, 1e-3 if qdt == torch.bfloat16 else 1e-5


# the flagship's self-attention (S = 104 greedy, 208 beam; H = 6, L = 256,
# dk = 64, the step's bias row), t5_small's cross-attention (S = 8, 16; T =
# 256, no bias, no position), grouped query rows (M = 2, 3), the other
# widths, a horizon n below L
INT8_CASES = {
    "flagship_greedy": (104, 6, 1, 256, 64, 256, True),
    "flagship_beam": (208, 6, 1, 256, 64, 256, True),
    "t5_cross_8": (8, 6, 1, 256, 64, 256, False),
    "t5_cross_16": (16, 6, 1, 256, 64, 256, False),
    "gqa_m2": (8, 3, 2, 256, 64, 256, True),
    "gqa_m3": (8, 2, 3, 128, 64, 128, True),
    "dk16": (8, 4, 1, 256, 16, 256, True),
    "dk32": (8, 4, 1, 256, 32, 256, True),
    "dk128": (8, 4, 1, 256, 128, 256, True),
    "horizon": (8, 6, 1, 1024, 64, 300, True),
    "m8_long": (2, 2, 8, 1024, 128, 1024, True),
}


@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16], ids=["q32", "q16"])
@pytest.mark.parametrize("case", list(INT8_CASES))
def test_int8_decode_attention_matches_plain(dev, case, qdt):
    """The kernel against the plain version over rows [0, n): at positions 0,
    the middle and n - 1 with the position on the host and on the card (the
    two outputs bit-identical), or with no position (cross-attention)."""
    S, Hkv, M, L_, dk, n, bias = INT8_CASES[case]
    gen = torch.Generator().manual_seed(S + M + dk + n)
    positions = (0, n // 2 - 1, n - 1) if bias else (None,)
    for pos in positions:
        q, kq_, ks, vq, vs, b = _int8_case(S, Hkv, M, L_, dk, n, pos, bias, gen, dev)
        q = q.to(qdt)
        before = kq.int8_decode_attention.launches
        got = kq.int8_decode_attention(q, kq_, ks, vq, vs, b, n=n, pos=pos)
        assert kq.int8_decode_attention.launches == before + 1
        want = kq.int8_decode_attention_plain(q, kq_[:, :, :n], ks[:, :, :n],
                                              vq[:, :, :n], vs[:, :, :n], b)
        if pos is not None:
            on_card = kq.int8_decode_attention(q, kq_, ks, vq, vs, b, n=n,
                                               pos=torch.tensor(pos, device=dev))
        torch.cuda.synchronize()
        assert got.dtype == qdt and got.shape == (S, Hkv, M, dk)
        if pos is not None:
            assert torch.equal(on_card, got), pos
        err = (got.float() - want.float()).abs()
        top, mean = _int8_err_bounds(vq[:, :, :n], vs[:, :, :n], want, qdt)
        assert err.max().item() < top, (pos, err.max().item(), top)
        assert err.mean().item() < mean, (pos, err.mean().item())


def test_int8_op_replays_in_a_cuda_graph(dev):
    """Captured once with the position in a tensor on the card, replayed at
    positions up and down by rewriting it: the host position's output at
    each, bit for bit (the flagship's beam shape)."""
    gen = torch.Generator().manual_seed(19)
    q, kq_, ks, vq, vs, _ = _int8_case(208, 6, 1, 256, 64, 256, None, False, gen, dev)
    q = q.to(torch.bfloat16)
    positions = (0, 63, 64, 127, 128, 200, 255)
    biases = {p: _int8_case(1, 6, 1, 1, 64, 256, p, True, gen, dev)[-1] for p in positions}
    bias = biases[0].clone()
    eager = {p: kq.int8_decode_attention(q, kq_, ks, vq, vs, biases[p], pos=p)
             for p in positions}
    pos = torch.tensor(0, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        kq.int8_decode_attention(q, kq_, ks, vq, vs, bias, pos=pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = kq.int8_decode_attention(q, kq_, ks, vq, vs, bias, pos=pos)
    for p in positions + positions[::-1]:
        pos.fill_(p)
        bias.copy_(biases[p])
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager[p]), p


def test_int8_wrapper_rejects_what_the_kernel_does_not_take(dev):
    gen = torch.Generator().manual_seed(4)
    q, kq_, ks, vq, vs, b = _int8_case(2, 2, 1, 64, 32, 64, 10, True, gen, dev)
    before = kq.int8_decode_attention.launches
    with pytest.raises(TypeError):
        kq.int8_decode_attention(q.double(), kq_, ks, vq, vs, b, pos=10)
    with pytest.raises(ValueError, match="dk"):
        kq.int8_decode_attention(q[..., :24].contiguous(), kq_[..., :24].contiguous(), ks,
                                 vq[..., :24].contiguous(), vs)
    with pytest.raises(ValueError, match="M="):
        kq.int8_decode_attention(q.expand(2, 2, 9, 32).contiguous(), kq_, ks, vq, vs)
    with pytest.raises(ValueError, match="contiguous"):
        kq.int8_decode_attention(q, kq_.transpose(2, 3).contiguous().transpose(2, 3),
                                 ks, vq, vs)
    with pytest.raises(ValueError, match="outside"):
        kq.int8_decode_attention(q, kq_, ks, vq, vs, b, pos=64)
    with pytest.raises(ValueError, match="rows"):
        kq.int8_decode_attention(q, kq_, ks, vq, vs, n=65)
    with pytest.raises(ValueError, match="bias has shape"):
        kq.int8_decode_attention(q, kq_, ks, vq, vs, b[..., :32], n=64, pos=10)
    with pytest.raises(ValueError, match="q on"):
        kq.int8_decode_attention(q, kq_.cpu(), ks, vq, vs)
    big = [torch.zeros(1, 1, 1025, 32, dtype=torch.int8, device=dev),
           torch.zeros(1, 1, 1025, device=dev)]
    with pytest.raises(ValueError, match="rows"):
        kq.int8_decode_attention(q[:1, :1], *big, *big)
    assert kq.int8_decode_attention.launches == before


# ---------------------------------------------------------------------------
# fused log-mel frontend and the launch probe

def _frontend(dev, **cfg):
    from yourmt3_tpu_torch.config.audio import AudioConfig
    from yourmt3_tpu_torch.ops.frontend import SpectrogramFrontend
    return SpectrogramFrontend.from_config(AudioConfig(**cfg), use_pallas=True,
                                           device=dev)


def _song(B, n, seed):
    """Sine mixtures over a noise floor (keeps mel bins above the log offset)."""
    gen = torch.Generator().manual_seed(seed)
    t = torch.arange(n) / 16000.0
    f0 = 110.0 + 770.0 * torch.rand(B, 4, 1, generator=gen)
    audio = 0.2 * torch.sin(2 * torch.pi * f0 * t).sum(1)
    return (audio + 0.02 * torch.randn(B, n, generator=gen)).float()


# B in {1, 8, 16} at the default config (T = 256 frames: every tile size
# divides it); input_frames 32000 gives T = 250 and 4095 gives T = 32 with
# n_fft 512, so the last frame tile runs past T
@pytest.mark.parametrize("B,cfg", [
    (1, {}), (8, {}), (16, {}), (8, {"input_frames": 32000}),
    (3, {"input_frames": 4095, "n_fft": 512, "n_mels": 128}),
    (2, {"power": 2.0}),
], ids=["B1", "B8", "B16", "B8-T250", "B3-nfft512", "B2-power2"])
def test_fused_logmel_matches_plain(dev, B, cfg):
    """The kernel against its algorithm's plain version (the same packed
    FFT and band-mel in plain PyTorch), and nearer a float64 log-mel than
    the function's two-level DFT plain version, by RMS over all entries.
    (The two fp32 routes can differ by more than 1e-3 at a mel bin in a
    deep spectral null of this song, where the float64 function finds the
    DFT plain version the farther of the two.)"""
    from yourmt3_tpu_torch.ops import fused_logmel as fl
    torch.backends.cuda.matmul.allow_tf32 = False
    fe = _frontend(dev, **cfg)
    audio = _song(B, fe.cfg.input_frames, B).to(dev)
    bases = (fe.basis_cos, fe.basis_sin, fe.mel_fb, fe.cfg)
    before = fl.fused_logmel.launches
    got = fe(audio)
    assert fl.fused_logmel.launches == before + 1
    want = fl.fused_logmel_fft_plain(audio, *bases)
    torch.cuda.synchronize()
    assert got.shape == (B, fe.cfg.num_frames, fe.cfg.n_mels)
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err < 1e-3, err
    ref = fl.fused_logmel_float64(audio, fe.basis_cos, fe.mel_fb, fe.cfg)
    dft = fl.fused_logmel_plain(audio, *bases)

    def rms(x):
        return (x.double() - ref).pow(2).mean().sqrt().item()

    assert rms(got) <= rms(dft), (rms(got), rms(dft))


def test_fused_logmel_op_replays_in_a_cuda_graph(dev):
    from yourmt3_tpu_torch.ops import fused_logmel as fl
    fe = _frontend(dev)
    audio = _song(16, fe.cfg.input_frames, 9).to(dev)
    packed = fl.pack_bases(fe.basis_cos, fe.basis_sin, fe.mel_fb)
    _replays_in_a_graph(lambda: fl.fused_logmel(
        audio, fe.basis_cos, fe.basis_sin, fe.mel_fb, fe.cfg, packed=packed))


def test_fused_logmel_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from yourmt3_tpu_torch.ops import cuda_build
    from yourmt3_tpu_torch.ops import fused_logmel as fl
    fe = _frontend(dev)
    audio = _song(2, fe.cfg.input_frames, 0).to(dev)
    args = (fe.basis_cos, fe.basis_sin, fe.mel_fb, fe.cfg)
    window, twiddles, bands, weights = fl.pack_bases(*args[:3])
    before = fl.fused_logmel.launches
    with pytest.raises(TypeError):
        fl.fused_logmel(audio.double(), *args)
    with pytest.raises(ValueError, match="audio must be"):
        fl.fused_logmel(audio[:, :1000].contiguous(), *args)
    with pytest.raises(ValueError, match="expected"):
        fl.fused_logmel(audio, fe.basis_cos, fe.basis_sin, fe.mel_fb[:-1], fe.cfg)
    with pytest.raises(ValueError, match="is on"):
        fl.fused_logmel(audio, *args, packed=(window.cpu(), twiddles, bands, weights))
    with pytest.raises(ValueError, match="power of two"):
        fl.fused_logmel(audio, *args, packed=(window[:1000], twiddles, bands, weights))
    with pytest.raises(ValueError, match="twiddles has shape"):
        fl.fused_logmel(audio, *args, packed=(window, twiddles[1:], bands, weights))
    with pytest.raises(TypeError):
        fl.fused_logmel(audio, *args, packed=(window, twiddles, bands.long(), weights))
    with pytest.raises(ValueError, match="frames_per_cta"):
        cfg = fe.cfg
        cuda_build.op("fused_logmel")(audio, window, twiddles, bands, weights,
                                      cfg.input_frames, cfg.num_frames, cfg.hop_length,
                                      float(cfg.log_offset), False, 3)
    assert fl.fused_logmel.launches == before


def test_launch_probe_adds_one_exactly(dev):
    from yourmt3_tpu_torch.ops import launch_probe as lp
    x = torch.randn(8, 128, generator=torch.Generator().manual_seed(0)).to(dev)
    before = lp.launch_probe.launches
    y = x
    for _ in range(5):
        y = lp.launch_probe(y)
    assert lp.launch_probe.launches == before + 5
    torch.cuda.synchronize()
    assert torch.equal(y, lp.launch_probe_plain(lp.launch_probe_plain(
        lp.launch_probe_plain(lp.launch_probe_plain(lp.launch_probe_plain(x))))))
    with pytest.raises(ValueError, match="shape"):
        lp.launch_probe(torch.zeros(4, 128, device=dev))


# the MoE flagship's and the conformer's encoders at a small width (the
# sizes of tests/test_torch_moe.py and tests/test_torch_conformer.py)
SMALL_ENCODERS = {
    "moe_flagship": ("perceiver_tf_mc13_moe", "mc13_full_plus_256",
                     dict(d_model=64, d_kv=16, num_heads=4, d_ff=128,
                          num_decoder_layers=2, ptf_d_latent=64,
                          ptf_num_blocks=1, conv_channels=8)),
    "conformer": ("conformer_small", "mt3_full_plus_256",
                  dict(d_model=64, d_kv=16, num_heads=4, d_ff=128,
                       num_encoder_layers=2, num_decoder_layers=2)),
}


@pytest.mark.parametrize("name", list(SMALL_ENCODERS))
def test_encoder_on_the_card_matches_the_cpu(dev, name):
    """The same seeded fp32 model on the card and on the CPU (TF32 off):
    the encoder output within 1e-3 (summation order only)."""
    from yourmt3_tpu_torch import api
    preset, task, ov = SMALL_ENCODERS[name]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(task=task, seed=0, compute_dtype="float32", **ov)
    gpu = api.init_model(preset, device=dev, **kw)
    cpu = api.init_model(preset, device="cpu", **kw)
    audio = _song(2, gpu.audio_cfg.input_frames, 0)
    with torch.no_grad():
        got = gpu.model.encoder(gpu.frontend(audio.to(dev))).cpu()
        want = cpu.model.encoder(cpu.frontend(audio))
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err < 1e-3, err
