"""The FFT algorithm of the port's fused log-mel kernel, in its plain
PyTorch version (`fused_logmel_fft_plain`), on the CPU: against the
two-level DFT plain version and the JAX package's Pallas kernel in
interpret mode, against a float64 numpy log-mel, and the kernel's packed
constants (window, twiddle table, mel bands) on their own."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from test_torch_fused_logmel import CASES, SMALL, TOL, _audio, _pair
from yourmt3_tpu.ops.frontend import SpectrogramFrontend as JaxFrontend
from yourmt3_tpu.ops.pallas.frontend_kernel import fused_logmel as jax_fused_logmel
from yourmt3_tpu_torch.config.audio import AudioConfig
from yourmt3_tpu_torch.ops import fused_logmel as fl
from yourmt3_tpu_torch.ops.frontend import (SpectrogramFrontend, hann_window,
                                            mel_filterbank)


def _bases(fe):
    return fe.basis_cos, fe.basis_sin, fe.mel_fb


@pytest.mark.parametrize("case", list(CASES))
def test_fft_plain_matches_plain_and_jax_pallas(case):
    kw, tile = CASES[case]
    jcfg, cfg = _pair(**kw)
    audio = _audio(cfg)
    jfe = JaxFrontend.from_config(jcfg)
    want_kernel = np.asarray(jax_fused_logmel(
        jnp.asarray(audio), jfe.basis_cos, jfe.basis_sin, jfe.mel_fb, jcfg,
        frames_per_tile=tile, freq_tile=128, interpret=True))
    fe = SpectrogramFrontend.from_config(cfg, use_pallas=True)
    x = torch.from_numpy(audio)
    got = fl.fused_logmel_fft_plain(x, *_bases(fe), cfg)
    plain = fl.fused_logmel_plain(x, *_bases(fe), cfg)
    assert got.shape == (2, cfg.num_frames, cfg.n_mels) == want_kernel.shape
    assert (got - plain).abs().max().item() < TOL
    assert np.abs(got.numpy() - want_kernel).max() < TOL


def _float64_logmel(audio, cfg):
    """The function in float64 numpy: reflect padding, periodic Hann
    window, rfft, magnitude, the float64 filterbank, log."""
    n, hop, T = cfg.n_fft, cfg.hop_length, cfg.num_frames
    x = np.pad(audio.astype(np.float64), ((0, 0), (n // 2, n // 2)), mode="reflect")
    x = np.pad(x, ((0, 0), (0, max(0, (T - 1) * hop + n - x.shape[1]))))
    frames = np.stack([x[:, t * hop:t * hop + n] for t in range(T)], 1)
    mag = np.sqrt(np.abs(np.fft.rfft(frames * hann_window(n), axis=-1)) ** 2 + 1e-12)
    if cfg.power == 2.0:
        mag = mag ** 2
    fb = mel_filterbank(n // 2 + 1, cfg.n_mels, cfg.sample_rate, cfg.f_min,
                        cfg.f_max, cfg.mel_htk, cfg.mel_norm)
    return np.log(np.maximum(mag @ fb, cfg.log_offset))


@pytest.mark.parametrize("case", list(CASES))
def test_fft_plain_is_nearer_float64_than_the_dft(case):
    """Measured as the RMS over all entries. The maximum sits at the
    quietest mel bin of the clip, where both routes' fp32 rounding of the
    windowed input dominates and either may come out ahead."""
    cfg = AudioConfig(**CASES[case][0])
    audio = _audio(cfg)
    fe = SpectrogramFrontend.from_config(cfg)
    x = torch.from_numpy(audio)
    ref = _float64_logmel(audio, cfg)

    def rms(out):
        return float(np.sqrt(((out.double().numpy() - ref) ** 2).mean()))

    fft = rms(fl.fused_logmel_fft_plain(x, *_bases(fe), cfg))
    dft = rms(fl.fused_logmel_plain(x, *_bases(fe), cfg))
    assert fft <= dft, (fft, dft)


@pytest.mark.parametrize("n_fft", [256, 512, 1024, 2048, 4096])
def test_stockham_fft_is_the_dft(n_fft):
    """The kernel's passes (first radix 4, 8, 2, 4, 8 by log2 n_fft mod 3,
    then radix 8) with its fp32 twiddle table, against numpy's float64
    FFT: within a few fp32 roundings of the largest bin."""
    rng = np.random.default_rng(n_fft)
    z = rng.standard_normal((3, n_fft)) + 1j * rng.standard_normal((3, n_fft))
    got = fl.stockham_fft(torch.from_numpy(z.astype(np.complex64)),
                          torch.from_numpy(fl.twiddle_table(n_fft))).numpy()
    want = np.fft.fft(z)
    assert np.abs(got - want).max() < 5e-7 * np.abs(want).max()
    radices = [r for r, _ in fl.fft_passes(n_fft)]
    assert int(np.prod(radices)) == n_fft and set(radices[1:]) <= {8}


def test_twiddle_table_is_float64_rounded_once():
    n_fft = 2048
    tw = fl.twiddle_table(n_fft)
    assert tw.dtype == np.float32 and tw.shape == (n_fft - 4, 2)
    first = fl.fft_passes(n_fft)[0][0]
    for _, ns in fl.fft_passes(n_fft)[1:]:
        for r in (1, 4, 7):
            q = np.arange(ns)
            ang = 2 * np.pi * r * q / (8 * ns)
            got = tw[(ns - first) + (r - 1) * ns + q]
            assert np.array_equal(got[:, 0], np.cos(ang).astype(np.float32))
            assert np.array_equal(got[:, 1], (-np.sin(ang)).astype(np.float32))


def test_pack_bases_recovers_the_window_exactly():
    cfg = AudioConfig(**SMALL)
    fe = SpectrogramFrontend.from_config(cfg)
    window, twiddles, _, _ = fl.pack_bases(*_bases(fe))
    assert torch.equal(window, fe.window)
    assert torch.equal(window, torch.tensor(hann_window(cfg.n_fft), dtype=torch.float32))
    assert np.array_equal(twiddles.numpy(), fl.twiddle_table(cfg.n_fft))


@pytest.mark.parametrize("n_mels", [128, 512])
def test_mel_bands_rebuild_the_filterbank_exactly(n_mels):
    """Every column's band holds all of its nonzero rows; scattering the
    weights back gives mel_fb bit for bit. Some low columns, narrower than
    a bin, have no nonzero row at all and get an empty band."""
    cfg = AudioConfig(**dict(SMALL, n_mels=n_mels))
    fe = SpectrogramFrontend.from_config(cfg)
    _, _, bands, weights = fl.pack_bases(*_bases(fe))
    assert bands.dtype == torch.int32 and bands.shape == (n_mels, 3)
    rebuilt = torch.zeros_like(fe.mel_fb)
    for m, (lo, hi, off) in enumerate(bands.tolist()):
        rebuilt[lo:hi, m] = weights[off:off + hi - lo]
    assert torch.equal(rebuilt, fe.mel_fb)
    widths = bands[:, 1] - bands[:, 0]
    assert int(widths.sum()) == weights.numel()
    assert torch.equal(bands[1:, 2], torch.cumsum(widths, 0)[:-1].int())
    assert bool((widths == 0).any())


def test_pack_bases_rejects_what_is_not_a_window_folded_dft():
    cfg = AudioConfig(**SMALL)
    fe = SpectrogramFrontend.from_config(cfg)
    cos, sin, mel = _bases(fe)
    gen = torch.Generator().manual_seed(0)
    bumped = cos.clone()
    bumped[100, 17] += 1e-4
    for bad_cos, bad_sin in [(torch.randn(cos.shape, generator=gen), sin),
                             (bumped, sin), (cos, -sin), (cos, cos)]:
        with pytest.raises(ValueError, match="window-folded DFT"):
            fl.pack_bases(bad_cos, bad_sin, mel)
    with pytest.raises(ValueError, match="expected"):
        fl.pack_bases(cos, sin, mel[:-1])


def test_another_window_folded_in_is_taken_and_matches_the_dft():
    """A Hamming window folded into the bases is a window-folded DFT too:
    the FFT takes it from the zero-frequency column."""
    cfg = AudioConfig(**SMALL)
    fe = SpectrogramFrontend.from_config(cfg)
    n = cfg.n_fft
    win = 0.54 - 0.46 * np.cos(2 * np.pi * np.arange(n) / n)
    t, f = np.arange(n)[:, None], np.arange(n // 2 + 1)[None, :]
    ang = 2 * np.pi * (t * f % n) / n
    cos = torch.tensor(np.cos(ang) * win[:, None], dtype=torch.float32)
    sin = torch.tensor(-np.sin(ang) * win[:, None], dtype=torch.float32)
    x = torch.from_numpy(_audio(cfg))
    got = fl.fused_logmel_fft_plain(x, cos, sin, fe.mel_fb, cfg)
    want = fl.fused_logmel_plain(x, cos, sin, fe.mel_fb, cfg)
    assert (got - want).abs().max().item() < TOL


@pytest.mark.parametrize("n_fft", [128, 1000, 1536, 8192])
def test_sizes_the_kernel_does_not_take_are_rejected(n_fft):
    with pytest.raises(ValueError, match="power of two from 256 to 4096"):
        fl.check_n_fft(n_fft)
    cos = torch.zeros(n_fft, n_fft // 2 + 1)
    with pytest.raises(ValueError, match="power of two"):
        fl.pack_bases(cos, cos, torch.zeros(n_fft // 2 + 1, 8))
