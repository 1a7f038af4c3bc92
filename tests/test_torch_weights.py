"""Weight bridge of the PyTorch port: JAX param tree → port state_dict.

The port's parameter names are the reference checkpoint names that the
JAX importer's `reference_style_state_dict` writes; the bridge must give
the same keys and arrays, load with strict=True, and map back unchanged
through the JAX importer."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yourmt3_tpu.config.model import get_model_config as jax_model_config
from yourmt3_tpu.models.ymt3 import YMT3 as JaxYMT3
from yourmt3_tpu.train.import_torch import (flatten_params, import_state_dict,
                                            reference_style_state_dict)
from yourmt3_tpu_torch.config.model import get_model_config
from yourmt3_tpu_torch.models.ymt3 import YMT3
from yourmt3_tpu_torch.weights import state_dict_from_jax


# the encoder families and options at a tiny width: (preset, overrides)
TINY_T5 = dict(d_model=64, d_kv=16, num_heads=4, d_ff=128,
               num_encoder_layers=2, num_decoder_layers=2)
TINY_PTF = dict(d_model=64, d_kv=16, num_heads=4, d_ff=128,
                num_decoder_layers=2, ptf_d_latent=64, ptf_num_blocks=1,
                conv_channels=8)
MODELS = {
    "t5_tiny": ("t5_tiny", {}),
    "t5_small": ("t5_small", {}),
    "perceiver_tf_mc13": ("perceiver_tf_mc13", {}),
    "moe_flagship": ("perceiver_tf_mc13_moe", TINY_PTF),
    "conformer": ("conformer_small", TINY_T5),
    "rope": ("perceiver_tf_mc13", dict(TINY_PTF, ptf_pos_enc="rope")),
    "alibi": ("perceiver_tf_mc13", dict(TINY_PTF, ptf_pos_enc="alibi")),
    "mlp": ("conformer_small", dict(TINY_T5, proj_type="mlp")),
    "depthwise-conv": ("conformer_small",
                       dict(TINY_T5, proj_type="depthwise-conv")),
    "group-conv": ("perceiver_tf_mc13", dict(TINY_PTF, proj_type="group-conv")),
}


def random_param_tree(preset: str, seed: int = 0, **overrides):
    """The preset's JAX param tree (shapes from eval_shape), numpy-filled."""
    cfg = jax_model_config(preset).replace(**overrides)
    feats = jnp.zeros((1, 256, 512), jnp.float32)
    ids = jnp.zeros((1, cfg.num_channels, 8), jnp.int32)
    shapes = jax.eval_shape(JaxYMT3(cfg).init, jax.random.PRNGKey(0), feats, ids)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("name", list(MODELS))
def test_bridge_matches_reference_names_and_loads(name):
    preset, overrides = MODELS[name]
    params = random_param_tree(preset, **overrides)
    want = reference_style_state_dict(params, prefix="")
    got = state_dict_from_jax(params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k

    model = YMT3(get_model_config(preset).replace(**overrides))
    result = model.load_state_dict(got, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # the port holds exactly these keys: nothing of its own beside them
    assert sorted(model.state_dict()) == sorted(want)


@pytest.mark.parametrize("name", list(MODELS))
def test_bridge_maps_back_through_the_jax_importer(name):
    preset, overrides = MODELS[name]
    params = random_param_tree(preset, seed=1, **overrides)
    port_sd = {k: v.numpy() for k, v in state_dict_from_jax(params).items()}
    back = import_state_dict(port_sd, params, verbose=False,
                             require_complete=True)
    want, got = flatten_params(params), flatten_params(back)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_t5_moe_bridge_round_trips():
    """ff_act="moe" has no reference naming: the bridge names each T5
    layer's router and stacked experts under its DenseReluDense, the
    result loads with strict=True, and the port's state_dict holds the
    same arrays (router transposed, experts as they are)."""
    overrides = dict(TINY_T5, ff_act="moe")
    params = random_param_tree("t5_tiny", seed=3, **overrides)
    with pytest.raises(ValueError, match="no inverse import rule"):
        reference_style_state_dict(params)
    got = state_dict_from_jax(params)
    model = YMT3(get_model_config("t5_tiny").replace(**overrides))
    model.load_state_dict(got, strict=True)
    sd = model.state_dict()
    assert sorted(sd) == sorted(got)
    flat = flatten_params(params)
    for side, lyr, i in (("encoder", "layer_1", 1), ("decoder", "layer_0", 2)):
        ff = f"{side}.block.{1 if side == 'encoder' else 0}.layer.{i}.DenseReluDense"
        assert np.array_equal(sd[f"{ff}.router.weight"].numpy(),
                              flat[f"{side}/{lyr}/ff/router/kernel"].T)
        for w in ("wi", "wo"):
            assert np.array_equal(sd[f"{ff}.experts_{w}"].numpy(),
                                  flat[f"{side}/{lyr}/ff/{w}"])
    assert sd["encoder.block.0.layer.1.DenseReluDense.experts_wi"].shape == (8, 64, 128)


def test_bridge_accepts_flat_paths_and_rejects_unknown():
    params = random_param_tree("t5_tiny", seed=2)
    flat = {"params/" + k: v for k, v in flatten_params(params).items()}
    a, b = state_dict_from_jax(params), state_dict_from_jax(flat)
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="no T5 rule"):
        state_dict_from_jax({"encoder": {"mystery": {"kernel": np.ones(2)}}})


def test_init_distributions_mirror_the_reference():
    """Random init: the query std carries the folded 1/sqrt(d_kv) scale,
    k/v/o are fan-in normal, embeddings N(0, 1), bias tables N(0, 0.02),
    norms ones, lm_head lecun truncated normal."""
    cfg = get_model_config("t5_small")
    model = YMT3(cfg)
    model.reset_parameters(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    d = cfg.d_model
    q = sd["decoder.block.3.layer.0.SelfAttention.q.weight"]
    k = sd["decoder.block.3.layer.0.SelfAttention.k.weight"]
    assert abs(q.std().item() - (d * cfg.d_kv) ** -0.5) < 0.05 * (d * cfg.d_kv) ** -0.5
    assert abs(k.std().item() - d ** -0.5) < 0.05 * d ** -0.5
    assert abs(sd["shared.weight"].std().item() - 1.0) < 0.02
    rel = sd["decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"]
    assert abs(rel.std().item() - 0.02) < 0.005
    assert torch.equal(sd["encoder.final_layer_norm.weight"], torch.ones(d))
    head = sd["lm_head.weight"]
    assert head.abs().max().item() <= 2 * d ** -0.5 / 0.87962566103423978 + 1e-6
    assert abs(head.std().item() - d ** -0.5) < 0.05 * d ** -0.5

    # the MoE flagship's stacked experts (its encoder at full width; one
    # decoder layer): flax's fan-in counts the expert axis (E·d for wi,
    # E·ff for wo); the router is lecun truncated normal
    moe = YMT3(get_model_config("perceiver_tf_mc13_moe").replace(num_decoder_layers=1))
    moe.reset_parameters(torch.Generator().manual_seed(0))
    sd = moe.state_dict()
    E, dl = 8, 128
    wi = sd["encoder.temporal_blocks.0.mlp.experts_wi"]
    wo = sd["encoder.spectral_blocks.2.mlp.experts_wo"]
    assert wi.shape == (E, dl, 4 * dl) and wo.shape == (E, 4 * dl, dl)
    assert abs(wi.std().item() - (E * dl) ** -0.5) < 0.02 * (E * dl) ** -0.5
    assert abs(wo.std().item() - (E * 4 * dl) ** -0.5) < 0.02 * (E * 4 * dl) ** -0.5
    router = sd["encoder.temporal_blocks.1.mlp.router.weight"]
    assert router.shape == (E, dl)
    assert router.abs().max().item() <= 2 * dl ** -0.5 / 0.87962566103423978 + 1e-6
