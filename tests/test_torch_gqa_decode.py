"""Grouped-query and multi-query decoding in the port (decoder_kv_heads)
against the JAX package, on the same weights in fp32 on the CPU.

- The grouped-query flagships perceiver_tf_mc13_mqa (one K/V head) and
  perceiver_tf_mc13_gqa2 (two) at a tiny width (4 query heads, 13
  channels), and the 3-channel multi-T5 decoder with one K/V head of the
  JAX package's tests/test_gqa_decode.py. The weights are the port's
  seed-0 init, carried to JAX through the reference checkpoint's names
  (the port's reference_style_state_dict, JAX's import_state_dict with
  require_complete), and both sides decode the port's memory.
- Greedy tokens with the fp32 cache are JAX's, and the port's per-step
  decode logits along them are within TOL of JAX's teacher-forced logits
  on the same memory; with the other caches JAX allows with grouped K/V
  (int8c4, int4) the flagships' tokens are JAX's on the same path.
- The flagships are served through transcribe_segments_array with the
  fast decode settings of a 13-channel decode (dense int8 self cache),
  the GQA flagship with the beam-2 repair: the notes and error counts are
  JAX's. The 3-channel model's beam-2 tokens are JAX's.
- The port's config refuses what JAX's refuses: the paged kernel and
  int8c4p's int4 cross kernel index caches by query head.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import yourmt3_tpu.api as japi
from yourmt3_tpu.api import ModelBundle as JaxModelBundle
from yourmt3_tpu.config.model import ModelConfig as JaxModelConfig
from yourmt3_tpu.config.model import get_model_config as jax_model_config
from yourmt3_tpu.models.decoding import beam_decode as jax_beam_decode
from yourmt3_tpu.models.decoding import greedy_decode as jax_greedy_decode
from yourmt3_tpu.models.ymt3 import YMT3 as JaxYMT3
from yourmt3_tpu.ops.frontend import SpectrogramFrontend as JaxFrontend
from yourmt3_tpu.tokens.task_manager import TaskManager as JaxTaskManager
from yourmt3_tpu.train.import_torch import import_state_dict
from yourmt3_tpu_torch import api
from yourmt3_tpu_torch.config.audio import AudioConfig
from yourmt3_tpu_torch.config.model import T5_TINY, ModelConfig, get_model_config
from yourmt3_tpu_torch.data.audio_io import slice_padded_array
from yourmt3_tpu_torch.models.decoding import beam_decode, greedy_decode
from yourmt3_tpu_torch.models.ymt3 import YMT3
from yourmt3_tpu_torch.ops.frontend import SpectrogramFrontend
from yourmt3_tpu_torch.tokens.codec import EOS_ID
from yourmt3_tpu_torch.tokens.task_manager import TaskManager
from yourmt3_tpu_torch.train.import_reference import reference_style_state_dict

from torch_port_util import one_intra_op_thread, sine_song  # noqa: F401

# the tiny flagship of tests/test_torch_flagship.py
TINY_FLAGSHIP = dict(d_model=64, d_kv=16, num_heads=4, d_ff=128, num_decoder_layers=2,
                     ptf_d_latent=64, ptf_num_blocks=1, conv_channels=8)
# name: (preset, task, overrides, mel bins)
MODELS = {
    "mqa": ("perceiver_tf_mc13_mqa", "mc13_full_plus_256", TINY_FLAGSHIP, None),
    "gqa2": ("perceiver_tf_mc13_gqa2", "mc13_full_plus_256", TINY_FLAGSHIP, None),
    "mqa_3ch": ("t5_tiny", None, dict(vocab_size=600, num_channels=3,
                                      decoder_type="multi-t5", decoder_kv_heads=1), 24),
}
FLAGSHIPS = ("mqa", "gqa2")
L = 32  # decode steps of the token tests
TOL = 1e-4


def _to_torch(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


def _jax_params(jm, port_model, feats_shape, channels):
    """The port model's weights as JAX params: the reference checkpoint's
    names, mapped by JAX's importer onto the shapes of JAX's init."""
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros(feats_shape),
                            jnp.zeros((1, channels, 8), jnp.int32))
    template = jax.tree_util.tree_map(lambda s: np.empty(s.shape, s.dtype), shapes)
    sd = {k: v.numpy() for k, v in reference_style_state_dict(port_model).items()}
    return import_state_dict(sd, template, verbose=False, require_complete=True)


def _build(name):
    """→ dict(name, jm: JAX model, params: JAX params, pm: port model with
    the same fp32 weights, mels: its input features, jmem: the port's
    memory as a JAX array, greedy: {kv_quant: JAX's greedy ids})."""
    preset, task, over, mels = MODELS[name]
    if task is None:  # a bare model at the JAX tests' shapes
        pm = YMT3(T5_TINY.replace(compute_dtype="float32", **over), mels)
        pm.reset_parameters(torch.Generator().manual_seed(0))
        feats = np.random.default_rng(3).standard_normal((2, 32, mels)).astype(np.float32)
        with torch.no_grad():
            memory = pm.eval().encode(torch.from_numpy(feats))
        jcfg = jax_model_config(preset).replace(compute_dtype="float32", **over)
        feats_shape = (1, 32, mels)
    else:
        pb = api.init_model(model_cfg=get_model_config(preset).replace(
            compute_dtype="float32", **over), task=task, device="cpu")
        pm, ac, mels = pb.model, pb.audio_cfg, pb.audio_cfg.num_feature_bins
        segments, _ = slice_padded_array(sine_song(4.0), ac.input_frames)
        with torch.no_grad():
            memory = api._encode_batch(pb, segments)
        assert memory.dtype == torch.bfloat16  # the group projection's
        jcfg = jax_model_config(preset).replace(
            compute_dtype="float32", vocab_size=pm.cfg.vocab_size,
            num_channels=pm.cfg.num_channels, max_target_length=pm.cfg.max_target_length,
            **over)
        feats_shape = (1, ac.num_frames, ac.num_feature_bins)
    jm = JaxYMT3(jcfg)
    jmem = jnp.asarray(memory.float().numpy()).astype(
        jnp.bfloat16 if memory.dtype == torch.bfloat16 else jnp.float32)
    return dict(name=name, jm=jm, params=_jax_params(jm, pm, feats_shape, jcfg.num_channels),
                pm=pm, mels=mels, jmem=jmem, greedy={})


@pytest.fixture(scope="module")
def pairs():
    """The models of MODELS, each built on first use."""
    built = {}

    def get(name):
        if name not in built:
            built[name] = _build(name)
        return built[name]
    return get


def _port_model(p, **overrides):
    model = YMT3(p["pm"].cfg.replace(**overrides), p["mels"])
    model.load_state_dict(p["pm"].state_dict(), strict=True)
    return model.eval()


def _port_memory(p):
    return _to_torch(p["jmem"]).to(torch.bfloat16 if p["jmem"].dtype == jnp.bfloat16
                                   else torch.float32)


def _jax_greedy(p, kv_quant):
    if kv_quant not in p["greedy"]:
        p["greedy"][kv_quant] = np.asarray(jax_greedy_decode(
            JaxYMT3(p["jm"].cfg.replace(kv_quant=kv_quant)), p["params"], p["jmem"],
            max_length=L))
    return p["greedy"][kv_quant]


@pytest.mark.parametrize("name", list(MODELS))
def test_greedy_tokens_and_step_logits_match_jax(pairs, name):
    """The fp32 grouped self cache: the port's greedy tokens are JAX's, and
    its decode-step logits along them (on the streams still running) are
    within TOL of JAX's teacher-forced logits on the same memory."""
    p = pairs(name)
    jm, pm = p["jm"], p["pm"]
    want = _jax_greedy(p, "none")
    B, C = want.shape[:2]
    S = B * C
    inputs = np.concatenate([np.zeros((B, C, 1), np.int64), want[..., :-1]], -1)

    def teacher_forced(m, ids, mem):
        return m.decoder(ids, mem, True) if m._multi else m.decoder(
            ids[:, 0], mem[:, 0], True)[:, None]
    tf = np.asarray(jax.jit(functools.partial(jm.apply, method=teacher_forced))(
        p["params"], jnp.asarray(inputs, jnp.int32), p["jmem"])).reshape(S, L, -1)
    mem = _port_memory(p)
    path = inputs.reshape(S, L)
    ended = np.zeros(S, bool)
    worst = 0.0
    with torch.no_grad():
        np.testing.assert_array_equal(greedy_decode(pm, mem, L).numpy(), want)
        cross = pm.init_cross_kv(mem)
        kvs = pm.empty_self_kvs(S, L)
        assert kvs[0][0].shape == (S, jm.cfg.decoder_kv_heads, L, jm.cfg.d_kv)
        for pos in range(L):
            logits, kvs = pm.decode_step(torch.from_numpy(path[:, pos:pos + 1]), pos,
                                         kvs, cross)
            if not ended.all():
                diff = np.abs(logits.numpy() - tf[:, pos])[~ended]
                worst = max(worst, float(diff.max()))
            ended |= want.reshape(S, L)[:, pos] == EOS_ID
    print(f"{name}: greedy tokens equal; max |step - teacher-forced logit| {worst:.2e}")
    assert worst < TOL, worst


@pytest.mark.parametrize("name", FLAGSHIPS)
@pytest.mark.parametrize("kv_quant", ["int8c4", "int4"])
def test_greedy_tokens_equal_jax_on_every_grouped_cache(pairs, name, kv_quant):
    """Greedy decoding of the same memory with the int4 cross K/V that JAX
    allows with grouped K/V (int8c4: int8 self cache; int4: int4 self
    cache too): the port's tokens are JAX's on the same path. The int8
    self cache is the served path (test_grouped_flagship_served_like_jax)."""
    p = pairs(name)
    want = _jax_greedy(p, kv_quant)
    with torch.no_grad():
        got = greedy_decode(_port_model(p, kv_quant=kv_quant), _port_memory(p), L).numpy()
    np.testing.assert_array_equal(got, want)


def test_beam_tokens_equal_jax(pairs):
    """Beam 2 over the 3-channel model's one K/V head: the port's best
    beams are JAX's (the flagships' beam is the served repair's)."""
    p = pairs("mqa_3ch")
    want = np.asarray(jax_beam_decode(p["jm"], p["params"], p["jmem"], max_length=L,
                                      beam_size=2))
    with torch.no_grad():
        got = beam_decode(p["pm"], _port_memory(p), L, beam_size=2).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,repair_beam", [("mqa", 0), ("gqa2", 2)])
def test_grouped_flagship_served_like_jax(pairs, name, repair_beam, monkeypatch):
    """The tiny grouped flagship through transcribe_segments_array with the
    fast decode settings of a 13-channel decode (dense int8 self cache, no
    paged kernel: JAX's api.fast_decode_overrides), the GQA flagship with
    the beam-2 repair, both sides on the port's memory: JAX's notes and
    error counts."""
    p = pairs(name)
    over = api.fast_decode_overrides(13, 256)
    assert over == japi.fast_decode_overrides(13, 256) == {"kv_quant": "int8"}
    preset, task, _, _ = MODELS[name]
    ac = AudioConfig()
    pb = api.ModelBundle(_port_model(p, **over), SpectrogramFrontend(ac),
                         TaskManager(task, ac), ac)
    jac = japi.DEFAULT_AUDIO
    jb = JaxModelBundle(JaxYMT3(p["jm"].cfg.replace(**over)), p["params"],
                        JaxFrontend.from_config(jac), JaxTaskManager(task, jac), jac)
    segments, starts = slice_padded_array(sine_song(4.0), ac.input_frames)
    starts = (starts / ac.sample_rate).tolist()
    memory = {"jax": p["jmem"], "port": _port_memory(p)}
    monkeypatch.setattr(japi, "_encode_batch", lambda *a: memory["jax"])
    monkeypatch.setattr(api, "_encode_batch", lambda *a: memory["port"])
    notes_j, err_j = japi.transcribe_segments_array(jb, segments, starts, batch_size=2,
                                                    repair_beam=repair_beam)
    steps = beam_decode.steps
    notes_p, err_p = api.transcribe_segments_array(pb, segments, starts, batch_size=2,
                                                   repair_beam=repair_beam)
    print(f"{preset}: {len(notes_p)} notes, {err_p.total()} errors, beam steps "
          f"{beam_decode.steps - steps}")
    assert [dataclasses.astuple(n) for n in notes_p] == \
        [dataclasses.astuple(n) for n in notes_j]
    assert dataclasses.astuple(err_p) == dataclasses.astuple(err_j)
    assert (beam_decode.steps > steps) == (repair_beam > 0)


@pytest.mark.parametrize("fields", [
    dict(num_heads=6, decoder_kv_heads=4),
    dict(num_heads=6, decoder_kv_heads=0),
    dict(num_heads=6, decoder_kv_heads=2, use_pallas_decode=True, kv_quant="int8"),
    dict(num_heads=6, decoder_kv_heads=2, use_pallas_decode=True),
    dict(num_heads=6, decoder_kv_heads=2, kv_quant="int8c4p"),
    dict(num_heads=6, decoder_kv_heads=6, use_pallas_decode=True, kv_quant="int8"),
    dict(num_heads=6, decoder_kv_heads=6, kv_quant="int8c4p"),
    dict(num_heads=6, decoder_kv_heads=1, kv_quant="int4"),
    dict(num_heads=6, decoder_kv_heads=1, kv_quant="int4", use_pallas_decode=True),
], ids=lambda f: "-".join(f"{k}={v}" for k, v in f.items()))
def test_config_refuses_what_jax_refuses(fields):
    def refused(cls):
        try:
            cls(**fields)
        except ValueError:
            return True
        return False
    assert refused(ModelConfig) == refused(JaxModelConfig)


@pytest.mark.parametrize("preset", ["perceiver_tf_mc13_mqa", "perceiver_tf_mc13_gqa2"])
def test_grouped_flagship_presets_refuse_the_kernels(preset):
    for over in (dict(kv_quant="int8c4p"), dict(use_pallas_decode=True),
                 dict(use_pallas_decode=True, kv_quant="int8")):
        with pytest.raises(ValueError, match="decoder_kv_heads"):
            get_model_config(preset).replace(**over)
        with pytest.raises(ValueError, match="decoder_kv_heads"):
            jax_model_config(preset).replace(**over)
