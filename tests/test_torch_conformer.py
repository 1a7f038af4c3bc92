"""The port's conformer encoder against the JAX package: conformer_small
cut to 2 blocks of width 64 (4 heads of 16, d_ff 128, a 2-layer T5
decoder) in fp32 with mt3_full_plus_256, weights bridged from JAX. The
conv module alone, the encoder for every `encoder_abs_pos`, then the
transcription of a two-segment sine song as a whole."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import yourmt3_tpu.api as japi
from yourmt3_tpu.models.conformer import ConformerConvModule as JaxConvModule
from yourmt3_tpu_torch import api
from yourmt3_tpu_torch.data.audio_io import slice_padded_array
from yourmt3_tpu_torch.models.conformer import ConformerConvModule, ConformerEncoder
from yourmt3_tpu_torch.models.decoding import greedy_decode

from torch_port_util import bridged_bundles, one_intra_op_thread, sine_song  # noqa: F401

TASK = "mt3_full_plus_256"
TINY = dict(d_model=64, d_kv=16, num_heads=4, d_ff=128, num_encoder_layers=2,
            num_decoder_layers=2)
BATCH = 2
# fp32 on both sides, sums in another order
TOL = 1e-4


@pytest.mark.parametrize("kernel_size", [15, 4])
def test_conv_module_matches_jax(kernel_size):
    """RMSNorm → pointwise_in → GLU → depthwise conv ("SAME", an even
    kernel pads one more after than before, as flax does) → conv_norm →
    SiLU → pointwise_out, within 1e-5."""
    d = 32
    x = np.random.default_rng(0).standard_normal((2, 40, d)).astype(np.float32)
    jm = JaxConvModule(d, kernel_size=kernel_size, dtype=jnp.float32)
    p = jax.tree_util.tree_map(np.array, jm.init(jax.random.PRNGKey(0),
                                                 jnp.asarray(x))["params"])
    want = np.asarray(jm.apply({"params": p}, jnp.asarray(x)))
    pm = ConformerConvModule(d, torch.float32, kernel_size=kernel_size)
    pm.load_state_dict({
        "norm.weight": torch.from_numpy(p["RMSNorm_0"]["scale"]),
        "pointwise_in.weight": torch.from_numpy(p["pointwise_in"]["kernel"].T.copy()),
        "depthwise.weight": torch.from_numpy(
            p["depthwise"]["kernel"].transpose(2, 1, 0).copy()),
        "conv_norm.weight": torch.from_numpy(p["conv_norm"]["scale"]),
        "pointwise_out.weight": torch.from_numpy(p["pointwise_out"]["kernel"].T.copy()),
    }, strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() < 1e-5


def _bundles(**overrides):
    return bridged_bundles("conformer_small", TASK, **TINY, **overrides)


@pytest.fixture(scope="module")
def bundles():
    return _bundles()


@pytest.fixture(scope="module")
def song(bundles):
    ac = bundles[1].audio_cfg
    segments, starts = slice_padded_array(sine_song(4.0), ac.input_frames)
    assert segments.shape[0] == BATCH
    return segments, (starts / ac.sample_rate).tolist()


@pytest.mark.parametrize("abs_pos", ["sinusoidal_per_block", "sinusoidal",
                                     "learned", "none"])
def test_conformer_encode_matches_jax(song, abs_pos):
    """The encoder output within TOL. "learned" adds nothing, as in the
    reference (no pos_embed), and no pre-encoder is built although
    conformer_small sets use_conv_pre_encoder."""
    jb, pb = _bundles(encoder_abs_pos=abs_pos)
    enc = pb.model.encoder
    assert isinstance(enc, ConformerEncoder) and pb.cfg.use_conv_pre_encoder
    assert not any("pre_encoder" in k or "pos_embed" in k
                   for k in pb.model.state_dict())
    feats = jb.frontend(jnp.asarray(song[0]))
    want = np.asarray(jb.model.apply(jb.params, feats,
                                     method=lambda m, f: m.encoder(f)))
    with torch.no_grad():
        got = enc(pb.frontend(torch.from_numpy(song[0]))).numpy()
    assert got.shape == (BATCH, 256, TINY["d_model"])
    err = np.abs(got - want).max()
    print(f"conformer {abs_pos}: max |diff| {err:.2e}")
    assert err < TOL


def test_conformer_transcription_matches_jax(bundles, song):
    """The slice as a whole from each side's own memory: identical greedy
    token ids, then identical notes and error counts from
    transcribe_audio_array with the beam-2 repair."""
    jb, pb = bundles
    segments, _ = song
    L = pb.task_manager.max_token_length
    prefix = pb.task_manager.subtask_prefix_ids()
    mem_j = japi._encode_batch(jb.model, jb.params, jb.frontend,
                               jnp.asarray(segments))
    with torch.no_grad():
        mem_p = api._encode_batch(pb, segments)
    assert mem_p.shape == (BATCH, 1, 256, TINY["d_model"])
    assert np.abs(mem_p.numpy() - np.asarray(mem_j)).max() < TOL
    jprefix = jnp.asarray(prefix, jnp.int32) if prefix else None
    ids_j = np.asarray(japi._decode_batch(
        jb.model, jb.params, mem_j,
        japi._cross_kv_batch(jb.model, jb.params, mem_j), L, jprefix))
    with torch.no_grad():
        ids_p = greedy_decode(pb.model, mem_p, L, prefix_ids=prefix).numpy()
    np.testing.assert_array_equal(ids_p, ids_j)

    audio = sine_song(4.0)
    notes_j, err_j = japi.transcribe_audio_array(jb, audio, batch_size=BATCH,
                                                 repair_beam=2)
    notes_p, err_p = api.transcribe_audio_array(pb, audio, batch_size=BATCH,
                                                repair_beam=2)
    assert [dataclasses.astuple(n) for n in notes_p] == \
        [dataclasses.astuple(n) for n in notes_j]
    assert len(notes_p) > 0
    assert dataclasses.astuple(err_p) == dataclasses.astuple(err_j)


def test_full_width_conformer_builds_and_encodes():
    """conformer_small at its published width (8 blocks of 512, 6 heads
    of 64, d_ff 1024, conv kernel 15) builds on the CPU and encodes one
    segment to finite (1, 1, 256, 512) memory."""
    b = api.init_model("conformer_small", "mt3_full_plus", device="cpu",
                       compute_dtype="float32")
    enc = b.model.encoder
    assert len(enc.conformer) == 8
    assert enc.conformer[0].conv.depthwise.weight.shape == (512, 1, 15)
    assert enc.rel_bias.weight.shape == (32, 6)
    segments, _ = slice_padded_array(sine_song(2.0), b.audio_cfg.input_frames)
    with torch.no_grad():
        mem = api._encode_batch(b, segments[:1])
    assert mem.shape == (1, 1, 256, 512) and bool(torch.isfinite(mem).all())
