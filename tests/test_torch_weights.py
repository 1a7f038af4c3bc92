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


def random_param_tree(preset: str, seed: int = 0):
    """The preset's JAX param tree (shapes from eval_shape), numpy-filled."""
    cfg = jax_model_config(preset)
    feats = jnp.zeros((1, 256, 512), jnp.float32)
    ids = jnp.zeros((1, cfg.num_channels, 8), jnp.int32)
    shapes = jax.eval_shape(JaxYMT3(cfg).init, jax.random.PRNGKey(0), feats, ids)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("preset", ["t5_tiny", "t5_small", "perceiver_tf_mc13"])
def test_bridge_matches_reference_names_and_loads(preset):
    params = random_param_tree(preset)
    want = reference_style_state_dict(params, prefix="")
    got = state_dict_from_jax(params)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k

    model = YMT3(get_model_config(preset))
    result = model.load_state_dict(got, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    # the port holds exactly these keys: nothing of its own beside them
    assert sorted(model.state_dict()) == sorted(want)


@pytest.mark.parametrize("preset", ["t5_tiny", "t5_small", "perceiver_tf_mc13"])
def test_bridge_maps_back_through_the_jax_importer(preset):
    params = random_param_tree(preset, seed=1)
    port_sd = {k: v.numpy() for k, v in state_dict_from_jax(params).items()}
    back = import_state_dict(port_sd, params, verbose=False,
                             require_complete=True)
    want, got = flatten_params(params), flatten_params(back)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


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
