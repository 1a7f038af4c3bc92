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


# S·H below the SM count (48, 96: split-KV with a merge) and above it
# (192, 624: one range, written directly); pos 700 leaves the last range
# partial; dk = 128 with bf16 pages
@pytest.mark.parametrize("qdt", [torch.float32, torch.bfloat16], ids=["q32", "q16"])
@pytest.mark.parametrize("S,dk,kind", [(8, 64, "int8"), (16, 64, "int8"), (32, 64, "int8"),
                                       (104, 64, "bf16"), (8, 128, "bf16"),
                                       (8, 16, "fp32")])
def test_paged_split_kv_matches_plain(dev, S, dk, kind, qdt):
    gen = torch.Generator().manual_seed(S + dk)
    pages, kw = _paged_case(S, dk, kind, gen, dev)
    q = torch.randn(S, H, dk, generator=gen).to(dev, qdt)
    for pos in (0, 63, 64, 700, L - 1):
        splits, rows = da.decode_splits(S, H, pos)
        assert splits == -(-(pos + 1) // rows)
        assert splits == 1 or rows % 64 == 0
        if S * H >= torch.cuda.get_device_properties(dev).multi_processor_count:
            assert splits == 1
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


def test_paged_op_replays_in_a_cuda_graph(dev):
    """Captured once (output, split workspace and merge inside the graph),
    replayed three times: the eager result each time."""
    gen = torch.Generator().manual_seed(7)
    pages, kw = _paged_case(S, DK, "int8", gen, dev)
    kw["dist_buckets"] = da.distance_buckets(BUCKETS, MAXD, dev)
    q = torch.randn(S, H, DK, generator=gen).to(dev, torch.bfloat16)
    pos = L - 1
    assert da.decode_splits(S, H, pos)[0] > 1
    eager = da.paged_decode_attention(q, pages["k"], pages["v"], pos, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da.paged_decode_attention(q, pages["k"], pages["v"], pos, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da.paged_decode_attention(q, pages["k"], pages["v"], pos, **kw)
    for _ in range(3):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


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
    from yourmt3_tpu_torch.ops import fused_logmel as fl
    torch.backends.cuda.matmul.allow_tf32 = False
    fe = _frontend(dev, **cfg)
    audio = _song(B, fe.cfg.input_frames, B).to(dev)
    before = fl.fused_logmel.launches
    got = fe(audio)
    assert fl.fused_logmel.launches == before + 1
    want = fl.fused_logmel_plain(audio, fe.basis_cos, fe.basis_sin, fe.mel_fb, fe.cfg)
    torch.cuda.synchronize()
    assert got.shape == (B, fe.cfg.num_frames, fe.cfg.n_mels)
    assert bool(torch.isfinite(got).all())
    err = (got - want).abs().max().item()
    assert err < 1e-3, err


def test_fused_logmel_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from yourmt3_tpu_torch.ops import fused_logmel as fl
    fe = _frontend(dev)
    audio = _song(2, fe.cfg.input_frames, 0).to(dev)
    args = (fe.basis_cos, fe.basis_sin, fe.mel_fb, fe.cfg)
    before = fl.fused_logmel.launches
    with pytest.raises(TypeError):
        fl.fused_logmel(audio.double(), *args)
    with pytest.raises(ValueError, match="audio must be"):
        fl.fused_logmel(audio[:, :1000].contiguous(), *args)
    with pytest.raises(ValueError, match="n_mels"):
        fl.fused_logmel(audio, fe.basis_cos, fe.basis_sin, fe.mel_fb[:, :100], fe.cfg)
    cs, mel = fl.pack_bases(fe.basis_cos, fe.basis_sin, fe.mel_fb)
    with pytest.raises(ValueError, match="q on|is on"):
        fl.fused_logmel(audio, *args, packed=(cs.cpu(), mel))
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
