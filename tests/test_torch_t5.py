"""The port's T5 model (t5_tiny, fp32, weights bridged from JAX) against
the JAX package: encoder, teacher-forced logits, cross K/V, the
decode_step paths of every (kv_quant, use_pallas_decode) pair that
ModelConfig accepts, and the stream reorder of every cache layout."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from yourmt3_tpu.models.decoding import _reorder_cache_streams as jax_reorder
from yourmt3_tpu.models.ymt3 import YMT3 as JaxYMT3
from yourmt3_tpu_torch.models.ymt3 import YMT3

from torch_port_util import bridged_bundles

TOL = 1e-4
# int8 paths: both sides quantize K/V rows to int8 at every step. A one-ulp
# difference in a K or V value (the two frameworks sum the projections in
# another order) can move it across a rounding boundary, i.e. by one int8
# level = scale/127 of that row, and that step then propagates through the
# following layers.
TOL_INT8 = 2e-2
# paths with int4 K/V (self or cross): the widest gap over weight and
# feature seeds 0-3 was 4.34e-4 (int8c4p; int8c4 4.28e-4, int4 and
# int8c4-paged 2.2e-4, int8c4p-paged 2.0e-6)
TOL_INT4 = 2e-3
STEPS, MAX_LEN, T_ENC = 8, 128, 64


@pytest.fixture(scope="module")
def models():
    jb, pb = bridged_bundles("t5_tiny", "mt3_full_plus_256")
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2, T_ENC, 512)).astype(np.float32)
    return jb, pb, feats


@pytest.fixture(scope="module")
def token_path(models):
    """One token path for both sides: the JAX dense path's greedy tokens."""
    jb, _, feats = models
    mem = jb.model.apply(jb.params, jnp.asarray(feats), method=JaxYMT3.encode)
    cross = jb.model.apply(jb.params, mem, method=JaxYMT3.init_cross_kv)
    kv = jb.model.empty_self_kvs(2, MAX_LEN)
    step = jax.jit(functools.partial(jb.model.apply, method=JaxYMT3.decode_step))
    path = np.zeros((2, STEPS + 1), np.int32)
    for pos in range(STEPS):
        logits, kv = step(jb.params, jnp.asarray(path[:, pos:pos + 1]),
                          jnp.asarray(pos, jnp.int32), kv, cross)
        path[:, pos + 1] = np.asarray(jnp.argmax(logits, -1))
    return path


def _port_model(pb, **overrides):
    m = YMT3(pb.cfg.replace(**overrides))
    m.load_state_dict(pb.model.state_dict(), strict=True)
    return m.eval()


def test_encoder_logits_and_cross_kv(models):
    jb, pb, feats = models
    ids = np.random.default_rng(1).integers(0, jb.cfg.vocab_size, (2, 1, 16))
    mem_j = jax.jit(functools.partial(jb.model.apply, method=JaxYMT3.encode))(
        jb.params, jnp.asarray(feats))
    logits_j = jax.jit(jb.model.apply)(jb.params, jnp.asarray(feats),
                                       jnp.asarray(ids, jnp.int32))
    cross_j = jb.model.apply(jb.params, mem_j, method=JaxYMT3.init_cross_kv)
    with torch.no_grad():
        mem_p = pb.model.encode(torch.from_numpy(feats))
        logits_p = pb.model(torch.from_numpy(feats), torch.from_numpy(ids))
        cross_p = pb.model.init_cross_kv(mem_p)
    assert mem_p.shape == (2, 1, T_ENC, 64)
    assert np.abs(mem_p.numpy() - np.asarray(mem_j)).max() < TOL
    assert logits_p.dtype == torch.float32
    assert np.abs(logits_p.numpy() - np.asarray(logits_j)).max() < TOL
    assert len(cross_p) == len(cross_j) == 2
    for (kp, vp), (kj, vj) in zip(cross_p, cross_j):
        assert np.abs(kp.numpy() - np.asarray(kj)).max() < TOL
        assert np.abs(vp.numpy() - np.asarray(vj)).max() < TOL


# every (kv_quant, use_pallas_decode) pair that ModelConfig accepts
PATHS = {  # id → (overrides, tolerance)
    "dense": ({}, TOL),
    "paged": ({"use_pallas_decode": True}, TOL),
    "int8-paged": ({"kv_quant": "int8", "use_pallas_decode": True}, TOL_INT8),
    "int8-dense": ({"kv_quant": "int8"}, TOL_INT8),
    "int4": ({"kv_quant": "int4"}, TOL_INT4),
    "int8c4": ({"kv_quant": "int8c4"}, TOL_INT4),
    "int8c4p": ({"kv_quant": "int8c4p"}, TOL_INT4),
    "int8c4-paged": ({"kv_quant": "int8c4", "use_pallas_decode": True}, TOL_INT4),
    "int8c4p-paged": ({"kv_quant": "int8c4p", "use_pallas_decode": True}, TOL_INT4),
}


@pytest.mark.parametrize("overrides,tol", list(PATHS.values()), ids=list(PATHS))
def test_decode_step_paths(models, token_path, overrides, tol):
    jb, pb, feats = models
    jm = JaxYMT3(jb.cfg.replace(**overrides))
    jstep = jax.jit(functools.partial(jm.apply, method=JaxYMT3.decode_step))
    pm = _port_model(pb, **overrides)
    mem_j = jb.model.apply(jb.params, jnp.asarray(feats), method=JaxYMT3.encode)
    cross_j = jm.apply(jb.params, mem_j, method=JaxYMT3.init_cross_kv)
    kv_j = jm.empty_self_kvs(2, MAX_LEN)
    with torch.no_grad():
        mem_p = pm.encode(torch.from_numpy(feats))
        cross_p = pm.init_cross_kv(mem_p)
        kv_p = pm.empty_self_kvs(2, MAX_LEN)
    # the same cache layouts as the reference
    for a, b in zip(_leaves(kv_j), _leaves(kv_p)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
    for pos in range(STEPS):
        tok = token_path[:, pos:pos + 1]
        lj, kv_j = jstep(jb.params, jnp.asarray(tok), jnp.asarray(pos, jnp.int32),
                         kv_j, cross_j)
        with torch.no_grad():
            lp, kv_p = pm.decode_step(torch.from_numpy(tok).long(), pos, kv_p, cross_p)
        err = np.abs(lp.numpy() - np.asarray(lj)).max()
        assert err < tol, (pos, err)


@pytest.mark.parametrize("overrides", [o for o, _ in PATHS.values()], ids=list(PATHS))
def test_stream_reorder_matches_jax(models, token_path, overrides):
    """A stream reorder through the self and the cross layout of each pair
    equals gathering JAX's caches along that layout's stream axis (pages
    on axis 1, everything else on axis 0): as new tensors (a compaction's
    gather) and in place (the beam's parents)."""
    jb, pb, feats = models
    jm = JaxYMT3(jb.cfg.replace(**overrides))
    jstep = jax.jit(functools.partial(jm.apply, method=JaxYMT3.decode_step))
    mem_j = jb.model.apply(jb.params, jnp.asarray(feats), method=JaxYMT3.encode)
    cross_j = jm.apply(jb.params, mem_j, method=JaxYMT3.init_cross_kv)
    kv_j = jm.empty_self_kvs(2, MAX_LEN)
    for pos in range(3):  # rows that differ between the streams
        _, kv_j = jstep(jb.params, jnp.asarray(token_path[:, pos:pos + 1]),
                        jnp.asarray(pos, jnp.int32), kv_j, cross_j)
    dec = _port_model(pb, **overrides).decoder
    kv_p, cross_p = _to_torch(kv_j), _to_torch(cross_j)
    for parent in ([1, 0, 1], [1, 1]):
        idx = torch.tensor(parent)
        for layout, port, ref in ((dec.self_cache, kv_p, kv_j),
                                  (dec.cross_cache, cross_p, cross_j)):
            want = _leaves(jax_reorder(ref, jnp.asarray(parent)))
            got = _leaves(layout.reorder(port, idx))
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert np.array_equal(a.numpy(), np.asarray(b)), parent
    dec.self_cache.reorder_(kv_p, torch.tensor([1, 1]))
    for a, b in zip(_leaves(kv_p), _leaves(jax_reorder(kv_j, jnp.asarray([1, 1])))):
        assert np.array_equal(a.numpy(), np.asarray(b))


def _to_torch(tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(t) for t in tree)
    return torch.from_numpy(np.array(tree))


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]
