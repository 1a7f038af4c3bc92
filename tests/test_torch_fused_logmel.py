"""The port's fused log-mel frontend (the plain version of the CUDA kernel,
which CPU tensors take) against the JAX package's Pallas kernel in
interpret mode and against its XLA frontend, on the small audio config of
tests/test_pallas_frontend.py. Inputs carry a noise floor: a mel bin near
the log offset holds mostly fp32 rounding, which the frameworks round
differently (ROADMAP Queue 3, log-mel near the floor)."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from yourmt3_tpu.config.audio import AudioConfig as JaxAudioConfig
from yourmt3_tpu.ops.frontend import SpectrogramFrontend as JaxFrontend
from yourmt3_tpu.ops.pallas.frontend_kernel import fused_logmel as jax_fused_logmel
from yourmt3_tpu_torch.config.audio import AudioConfig
from yourmt3_tpu_torch.ops import fused_logmel as fl
from yourmt3_tpu_torch.ops.frontend import SpectrogramFrontend

TOL = 1e-3
SMALL = dict(input_frames=4095, n_fft=512, hop_length=128, n_mels=128)


def _audio(cfg, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(cfg.input_frames) / cfg.sample_rate
    tones = 0.2 * np.sin(2 * np.pi * rng.uniform(110, 3000, (batch, 3, 1)) * t).sum(1)
    return (tones + 0.05 * rng.standard_normal((batch, cfg.input_frames))
            ).astype(np.float32)


def _pair(**kw):
    return JaxAudioConfig(**kw), AudioConfig(**kw)


# (config, the Pallas kernel's frames_per_tile): 32 frames in tiles of 16,
# 16 frames in tiles of 10 (the last tile reads zero-padded blocks)
CASES = {
    "small": (SMALL, 16),
    "nondivisible": (dict(SMALL, input_frames=2047), 10),
    "power2": (dict(SMALL, power=2.0), 16),
    "mels64": (dict(SMALL, n_mels=64), 8),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_logmel_matches_jax_pallas_and_xla(case):
    kw, tile = CASES[case]
    jcfg, cfg = _pair(**kw)
    audio = _audio(cfg)
    jfe = JaxFrontend.from_config(jcfg)
    want_kernel = np.asarray(jax_fused_logmel(
        jnp.asarray(audio), jfe.basis_cos, jfe.basis_sin, jfe.mel_fb, jcfg,
        frames_per_tile=tile, freq_tile=128, interpret=True))
    want_xla = np.asarray(jfe(jnp.asarray(audio)))
    fe = SpectrogramFrontend.from_config(cfg, use_pallas=True)
    x = torch.from_numpy(audio)
    plain = fl.fused_logmel_plain(x, fe.basis_cos, fe.basis_sin, fe.mel_fb, cfg)
    via_frontend = fe(x)
    assert plain.shape == (2, cfg.num_frames, cfg.n_mels) == want_kernel.shape
    assert torch.equal(plain, via_frontend)  # CPU tensors take the plain version
    assert np.abs(plain.numpy() - want_kernel).max() < TOL
    assert np.abs(plain.numpy() - want_xla).max() < TOL


def test_default_frontend_is_unfused_and_matches_plain():
    """use_pallas defaults to False, as in JAX; both routes agree (their
    DFT sums are taken in another order: one product vs blocks of 32)."""
    cfg = AudioConfig(**SMALL)
    fe = SpectrogramFrontend.from_config(cfg)
    assert fe.use_pallas is False
    assert SpectrogramFrontend(cfg).use_pallas is False
    x = torch.from_numpy(_audio(cfg, seed=1))
    got = SpectrogramFrontend.from_config(cfg, use_pallas=True)(x)
    assert (got - fe(x)).abs().max().item() < 1e-4


def test_spec_codec_never_takes_the_kernel():
    cfg = AudioConfig(codec="spec", n_mels=0, **{k: v for k, v in SMALL.items()
                                                  if k != "n_mels"})
    fe = SpectrogramFrontend.from_config(cfg, use_pallas=True)
    assert fe.mel_fb is None
    x = torch.from_numpy(_audio(cfg))
    jfe = JaxFrontend.from_config(JaxAudioConfig(**dataclasses.asdict(cfg)),
                                  use_pallas=True)
    got = fe(x).numpy()
    assert got.shape == (2, cfg.num_frames, cfg.n_fft // 2 + 1)
    assert np.abs(got - np.asarray(jfe(jnp.asarray(x.numpy())))).max() < TOL


def test_packed_bases_are_the_kernel_layout():
    """pack_bases at the default config: the window (the bases'
    zero-frequency column), the twiddles of the three radix-8 passes after
    the first radix-4 one, and one band of weights per mel column."""
    cfg = AudioConfig()
    fe = SpectrogramFrontend(cfg)
    window, twiddles, bands, weights = fl.pack_bases(fe.basis_cos, fe.basis_sin,
                                                     fe.mel_fb)
    assert fl.fft_passes(cfg.n_fft) == [(4, 1), (8, 4), (8, 32), (8, 256)]
    assert window.shape == (cfg.n_fft,) and torch.equal(window, fe.basis_cos[:, 0])
    assert twiddles.shape == (cfg.n_fft - 4, 2) and twiddles.dtype == torch.float32
    assert bands.shape == (cfg.n_mels, 3) and bands.dtype == torch.int32
    lo, hi, off = bands.long().unbind(1)
    assert bool((lo <= hi).all()) and int(hi.max()) <= cfg.n_fft // 2 + 1
    assert int(off[-1] + hi[-1] - lo[-1]) == weights.numel()
    assert int((hi - lo).max()) <= 16  # each bin feeds at most two mels


@pytest.mark.parametrize("batch,tile", [(1, 2), (8, 8), (16, 16), (48, 16)])
def test_frame_tiles_cover_the_card(batch, tile):
    """The kernel's frames per CTA at T = 256 on 132 SMs: the largest tile
    whose grid still gives every SM a CTA."""
    assert fl.frames_per_cta(batch, 256, 132) == tile
    assert batch * -(-256 // tile) >= 132 or tile == 2
