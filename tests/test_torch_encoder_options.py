"""The port's encoder options against the JAX package: the rope and ALiBi
positions, every encoder→decoder projection branch, the T5 layers with
ff_act="moe", one train step of the tiny MoE flagship and of the tiny
conformer, and every option built at its published width with bridged
weights. fp32 on the CPU unless a test says otherwise."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yourmt3_tpu.api import init_model as jax_init_model
from yourmt3_tpu.config.audio import AudioConfig as JaxAudioConfig
from yourmt3_tpu.config.model import get_model_config as jax_model_config
from yourmt3_tpu.models.layers import alibi_bias as jax_alibi_bias
from yourmt3_tpu.models.layers import rope_rotate as jax_rope_rotate
from yourmt3_tpu.models.projection import EncoderProjection as JaxProjection
from yourmt3_tpu.models.ymt3 import YMT3 as JaxYMT3
from yourmt3_tpu_torch import api
from yourmt3_tpu_torch.config.audio import AudioConfig
from yourmt3_tpu_torch.config.model import get_model_config
from yourmt3_tpu_torch.models.layers import MoEFeedForward, QuantDense, alibi_bias, rope_rotate
from yourmt3_tpu_torch.models.projection import EncoderProjection
from yourmt3_tpu_torch.weights import state_dict_from_jax

import test_torch_train as train_parity
from torch_port_util import bridged_bundles, numpy_params, one_intra_op_thread  # noqa: F401

TOL = 1e-4
TINY_T5 = dict(d_model=64, d_kv=16, num_heads=4, d_ff=128,
               num_encoder_layers=2, num_decoder_layers=2)
TINY_PTF = dict(d_model=64, d_kv=16, num_heads=4, d_ff=128,
                num_decoder_layers=2, ptf_d_latent=64, ptf_num_blocks=1,
                conv_channels=8)


@pytest.mark.parametrize("shape,dtype", [
    ((2, 4, 256, 32), torch.float32), ((3, 2, 7, 16), torch.float32),
    ((2, 4, 256, 32), torch.bfloat16)], ids=["t256", "t7", "bf16"])
def test_rope_rotate_matches_jax(shape, dtype):
    """Half-split pairs, base 10000, angles in fp32: within 2e-6 of the
    input's scale in fp32 (sin and cos of angles up to 255 rad round
    differently), within one bf16 ulp in bf16."""
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = np.asarray(jax_rope_rotate(jnp.asarray(x, jdt)).astype(jnp.float32))
    got = rope_rotate(torch.from_numpy(x).to(dtype))
    assert got.dtype == dtype
    got = got.float().numpy()
    if dtype == torch.float32:
        assert np.abs(got - want).max() < 2e-6
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
        assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("heads,q_len,k_len", [(2, 256, 256), (6, 17, 33),
                                               (8, 1, 9)])
def test_alibi_bias_matches_jax(heads, q_len, k_len):
    """-slope·|i - j|, the slopes 2^(-8h/H): bit for bit."""
    want = np.asarray(jax_alibi_bias(heads, q_len, k_len))
    got = alibi_bias(heads, q_len, k_len)
    assert got.shape == (1, heads, q_len, k_len) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# projection branch → (preset, overrides, encoder output shape, ulps): the
# memory is bf16 on both sides; JAX's bf16 gelu rounds after each of its
# ops and the port's once, so "mlp" may sit up to 2 ulps off
PROJECTIONS = {
    "linear": ("conformer_small", {}, (2, 64, 512), 0),
    "linear-forced": ("conformer_small", {"proj_type": "linear-forced"},
                      (2, 64, 512), 1),
    "mlp": ("conformer_small", {"proj_type": "mlp"}, (2, 64, 512), 2),
    "depthwise-conv": ("conformer_small", {"proj_type": "depthwise-conv"},
                       (2, 64, 512), 1),
    "t5-mlp-3ch": ("t5_tiny", {"proj_type": "mlp", "num_channels": 3},
                   (2, 64, 64), 2),
    "group-linear": ("perceiver_tf_mc13", {"num_channels": 13},
                     (2, 64, 26, 128), 1),
    "group-conv": ("perceiver_tf_mc13", {"num_channels": 13,
                                         "proj_type": "group-conv"},
                   (2, 64, 26, 128), 1),
}


@pytest.mark.parametrize("branch", list(PROJECTIONS))
def test_projection_branch_matches_jax(branch):
    """Each branch on the same fp32 encoder output: the port's memory
    within `ulps` bf16 ulps (taken at magnitude 1 or more) of JAX's, and
    in JAX's dtype (bf16 unless the projection is the identity)."""
    preset, ov, shape, ulps = PROJECTIONS[branch]
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    jm = JaxProjection(jax_model_config(preset).replace(**ov))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jm.apply(params, jnp.asarray(x))
    pm = EncoderProjection(get_model_config(preset).replace(**ov))
    sd = state_dict_from_jax({"projection": numpy_params(params).get("params", {})})
    pm.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()},
                       strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape
    assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                         else torch.float32)
    a, b = np.asarray(want.astype(jnp.float32)), got.float().numpy()
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    assert (np.abs(a - b) <= ulps * ulp).all()
    print(f"{branch}: {(a != b).mean():.3%} of entries differ")


@pytest.fixture(scope="module")
def t5_moe():
    return bridged_bundles("t5_tiny", "mt3_full_plus_256", ff_act="moe")


@pytest.mark.parametrize("what", ["encode", "teacher_forced", "decode_steps",
                                  "decode_steps_int8_weights"])
def test_t5_moe_matches_jax(t5_moe, what):
    """T5 layers with ff_act="moe" (8 experts of d_ff, top-2) in the
    encoder and the decoder: the memory, the teacher-forced logits and 32
    decode steps' logits along JAX's greedy path within TOL. Under
    weight_quant="int8" the MoE keeps reading its fp32 weights on both
    sides (the other decoder layers read int8), within 2e-2."""
    jb, pb = t5_moe
    rng = np.random.default_rng(2)
    audio = (0.1 * rng.standard_normal((2, pb.audio_cfg.input_frames))).astype(np.float32)
    feats_j = jb.frontend(jnp.asarray(audio))
    with torch.no_grad():
        feats_p = pb.frontend(torch.from_numpy(audio))
        mem_p = pb.model.encode(feats_p)
    mem_j = jb.model.apply(jb.params, feats_j, method=JaxYMT3.encode)
    if what == "encode":
        assert np.abs(mem_p.numpy() - np.asarray(mem_j)).max() < TOL
        return
    if what == "teacher_forced":
        ids = rng.integers(3, pb.cfg.vocab_size, (2, 1, 24)).astype(np.int32)
        want = jb.model.apply(jb.params, feats_j, jnp.asarray(ids))
        with torch.no_grad():
            got = pb.model(feats_p, torch.from_numpy(ids).long())
        assert np.abs(got.numpy() - np.asarray(want)).max() < TOL
        return
    mode = "int8" if what.endswith("int8_weights") else "none"
    jcfg = jb.cfg.replace(weight_quant=mode)
    jm = JaxYMT3(jcfg)
    params = {"params": jb.params["params"]}
    if mode != "none":
        from yourmt3_tpu.ops.weight_quant import quantize_decoder_weights
        params["qweights"] = quantize_decoder_weights(params, mode)
    pm = api.ModelBundle(pb.model, pb.frontend, pb.task_manager,
                         pb.audio_cfg).with_decode_overrides(weight_quant=mode).model
    moe = [m for m in pm.decoder.modules() if isinstance(m, MoEFeedForward)]
    assert len(moe) == 2 and not any(isinstance(c, QuantDense)
                                     for m in moe for c in m.modules())
    jstep = jax.jit(functools.partial(jm.apply, method=JaxYMT3.decode_step))
    S, L = 2, 32
    cross_j = jm.apply(params, mem_j, method=JaxYMT3.init_cross_kv)
    kv_j = jm.empty_self_kvs(S, L)
    tok = np.zeros((S, 1), np.int32)
    worst = 0.0
    with torch.no_grad():
        cross_p = pm.init_cross_kv(torch.from_numpy(np.array(mem_j)))
        kv_p = pm.empty_self_kvs(S, L)
        for pos in range(L):
            lj, kv_j = jstep(params, jnp.asarray(tok), jnp.asarray(pos, jnp.int32),
                             kv_j, cross_j)
            lp, kv_p = pm.decode_step(torch.from_numpy(tok).long(), pos, kv_p,
                                      cross_p)
            worst = max(worst, float(np.abs(lp.numpy() - np.asarray(lj)).max()))
            tok = np.asarray(jnp.argmax(lj, -1))[:, None].astype(np.int32)
    print(f"{what}: max |logit diff| {worst:.2e}")
    assert worst < (2e-2 if mode == "int8" else TOL)


@pytest.mark.parametrize("model", ["moe_flagship", "conformer"])
def test_train_step_matches_jax(model):
    """One AdamW step (fp32, no dropout, the small audio config): the loss
    within 1e-4 and the gradient norm within 1e-3 relative. The MoE
    flagship's gradient passes through the bf16 group projection, as in
    tests/test_torch_train.py::test_tiny_flagship_train_step_matches_jax."""
    small = train_parity.SMALL
    if model == "moe_flagship":
        preset, task, ov = "perceiver_tf_mc13_moe", "mc13_full_plus_256", TINY_PTF
    else:
        preset, task, ov = "conformer_small", "mt3_full_plus_256", TINY_T5
    kw = dict(task=task, compute_dtype="float32", dropout_rate=0.0)
    jb = jax_init_model(model_cfg=jax_model_config(preset).replace(**ov),
                        audio_cfg=JaxAudioConfig(**small), **kw)
    pb = api.init_model(model_cfg=get_model_config(preset).replace(**ov),
                        audio_cfg=AudioConfig(**small), device="cpu", **kw)
    pb.model.load_state_dict(state_dict_from_jax(numpy_params(jb.params)),
                             strict=True)
    batch = train_parity.make_batch(pb.task_manager, pb.audio_cfg, batch=1,
                                    pad_from=40)
    opt = dict(name="adamw", base_lr=1e-3, schedule="constant", grad_clip=1.0)
    jm, pm, _ = train_parity._run_steps(jb, pb, [batch], opt, steps=1)
    assert np.isfinite(pm[0]["loss"])
    print(f"{model}: loss {pm[0]['loss']:.6f} / {jm[0]['loss']:.6f}, grad norm "
          f"{pm[0]['grad_norm']:.6f} / {jm[0]['grad_norm']:.6f}")
    assert abs(pm[0]["loss"] - jm[0]["loss"]) < 1e-4
    assert abs(pm[0]["grad_norm"] - jm[0]["grad_norm"]) <= 1e-3 * jm[0]["grad_norm"]


def _jax_param_tree(cfg, seed=0):
    """JAX's param tree of `cfg` at full width (shapes from eval_shape),
    numpy-filled."""
    feats = jnp.zeros((1, 256, 512), jnp.float32)
    ids = jnp.zeros((1, cfg.num_channels, 8), jnp.int32)
    shapes = jax.eval_shape(JaxYMT3(cfg).init, jax.random.PRNGKey(0), feats, ids)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("preset,task,ov", [
    ("perceiver_tf_mc13_moe", "mc13_full_plus_256", {}),
    ("conformer_small", "mt3_full_plus", {}),
    ("perceiver_tf_mc13", "mc13_full_plus_256", {"ptf_pos_enc": "rope"}),
    ("perceiver_tf_mc13", "mc13_full_plus_256", {"ptf_pos_enc": "alibi"}),
    ("perceiver_tf_mc13", "mc13_full_plus_256", {"proj_type": "group-conv"}),
    ("conformer_small", "mt3_full_plus", {"proj_type": "mlp"}),
    ("conformer_small", "mt3_full_plus", {"proj_type": "depthwise-conv"}),
    ("conformer_small", "mt3_full_plus", {"proj_type": "linear-forced"}),
    ("t5_small", "mt3_full_plus", {"ff_act": "moe"}),
], ids=["moe-flagship", "conformer", "rope", "alibi", "group-conv", "mlp",
        "depthwise-conv", "linear-forced", "t5-moe"])
def test_full_width_option_builds_and_loads_jax_weights(preset, task, ov):
    """api.init_model builds the option at its published width on the CPU,
    and JAX's param tree of the same config loads with strict=True."""
    b = api.init_model(preset, task, device="cpu", **ov)
    params = _jax_param_tree(jax_model_config(preset).replace(
        vocab_size=b.cfg.vocab_size, num_channels=b.cfg.num_channels,
        max_target_length=b.cfg.max_target_length, **ov))
    b.model.load_state_dict(state_dict_from_jax(params), strict=True)
