"""The port's reference-checkpoint importer (train/import_reference.py)
against the JAX package's (train/import_torch.py) on the same Lightning-
style files, and the bridge from the JAX package's Orbax checkpoints
through the export recipe into the port's restore_bundle.

The files are synthesized from the JAX package's own
`reference_style_state_dict` in three forms: as written (prefix
`model.`), with the MoE flagship's stacked expert tensors cut into the
reference's per-expert linear weights, and under the other prefixes the
importers strip. Both importers load a file into a model with other
weights; the two models must then give the same fp32 logits (1e-4) and
the same greedy tokens."""

import dataclasses
import json
import os
import shlex
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from yourmt3_tpu import api as japi
from yourmt3_tpu.config.model import get_model_config as jax_model_config
from yourmt3_tpu.models.ymt3 import YMT3 as JaxYMT3
from yourmt3_tpu.ops.frontend import SpectrogramFrontend as JaxFrontend
from yourmt3_tpu.tokens.task_manager import TaskManager as JaxTaskManager
from yourmt3_tpu.models.ymt3 import shift_right as jax_shift_right
from yourmt3_tpu.train import import_torch
from yourmt3_tpu.train.checkpoint import restore_bundle as jax_restore_bundle
from yourmt3_tpu.train.checkpoint import save_bundle as jax_save_bundle
from yourmt3_tpu_torch.api import init_model, load_checkpoint
from yourmt3_tpu_torch.config.audio import AudioConfig
from yourmt3_tpu_torch.models.decoding import greedy_decode
from yourmt3_tpu_torch.models.ymt3 import shift_right
from yourmt3_tpu_torch.train import import_reference
from yourmt3_tpu_torch.train.checkpoint import (EXPORT_RECIPE, REFERENCE_EXPORT,
                                                save_bundle)

from torch_port_util import one_intra_op_thread  # noqa: F401

SMALL = dict(input_frames=4095, n_fft=512, hop_length=128, n_mels=64)
TINY_MOE = dict(d_model=64, d_kv=16, num_heads=4, d_ff=128, num_decoder_layers=2,
                ptf_num_latents=26, ptf_d_latent=32, ptf_num_blocks=1,
                ptf_num_moe_experts=4)
MODELS = {"t5_tiny": ("t5_tiny", "mt3_full_plus_256", {}),
          "moe_flagship": ("perceiver_tf_mc13_moe", "mc13_full_plus_256", TINY_MOE)}
FORMS = ("plain", "per_expert", "other_prefixes")
TOL_LOGITS = 1e-4
DECODE_LEN = 24


def jax_bundle(preset, task, overrides, seed):
    """JAX's `api.init_model` in fp32 at the small audio config, with its
    model.init jitted (the eager init takes three times as long)."""
    ac = japi.AudioConfig(**SMALL)
    tm = JaxTaskManager(task, ac)
    cfg = jax_model_config(preset).replace(
        vocab_size=tm.vocab_size, num_channels=tm.num_decoding_channels,
        max_target_length=tm.max_token_length, compute_dtype="float32", **overrides)
    model = JaxYMT3(cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 jnp.zeros((1, ac.num_frames, ac.num_feature_bins)),
                                 jnp.zeros((1, cfg.num_channels, 8), jnp.int32))
    return japi.ModelBundle(model, params, JaxFrontend.from_config(ac), tm, ac)


def port_model(preset, task, overrides, seed):
    """The port's fp32 model with weights of its own (another seed)."""
    return init_model(preset, task, audio_cfg=AudioConfig(**SMALL), seed=seed,
                      device="cpu", compute_dtype="float32", **overrides).model


def write_ckpt(path, sd):
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v, np.float32))
                               for k, v in sd.items()},
                "epoch": 7, "global_step": 1234}, path)


def reference_file(tmp, jb, form):
    """JAX's reference-style state dict of jb's weights, in `form`."""
    sd = import_torch.reference_style_state_dict(jb.params)
    if form == "per_expert":
        out = {}
        for k, v in sd.items():
            base, _, which = k.rpartition(".experts_")
            if base and which in ("wi", "wo"):
                for e in range(v.shape[0]):
                    out[f"{base}.experts.{e}.{which}.weight"] = v[e].T
            else:
                out[k] = v
        assert len(out) > len(sd) or "experts_wi" not in "".join(sd)
        sd = out
    elif form == "other_prefixes":
        prefixes = ("module.", "ymt3.", "net.", "")
        sd = {prefixes[i % 4] + k[len("model."):]: v
              for i, (k, v) in enumerate(sd.items())}
    path = os.path.join(str(tmp), f"{form}.ckpt")
    write_ckpt(path, sd)
    return path


def inputs(jb, seed=3):
    rng = np.random.default_rng(seed)
    ac = jb.audio_cfg
    feats = rng.standard_normal((2, ac.num_frames, ac.num_feature_bins)).astype(np.float32)
    labels = rng.integers(3, jb.cfg.vocab_size, (2, jb.cfg.num_channels, 16)).astype(np.int32)
    return feats, labels


def jax_memory(jb, params, feats):
    return jb.model.apply(params, jnp.asarray(feats), method=lambda m, f: m.encode(f))


def to_port(mem):
    dtype = torch.bfloat16 if mem.dtype == jnp.bfloat16 else torch.float32
    return torch.from_numpy(np.array(mem, np.float32)).to(dtype)


def jax_logits(jb, params, mem, labels):
    """Teacher-forced logits of JAX's decoder on the memory `mem`."""
    ids = jax_shift_right(jnp.asarray(labels))

    def decode(m, i, me):
        if m._multi:
            return m.decoder(i, me, True)
        return m.decoder(i[:, 0], me[:, 0], True)[:, None]
    return np.asarray(jb.model.apply(params, ids, mem, method=decode))


def port_logits(model, mem, labels):
    """The same through the port's decoder (YMT3.forward after encode)."""
    ids = shift_right(torch.from_numpy(labels).long())
    with torch.no_grad():
        y = model.embed(ids)
        h = (model.decoder(y, mem) if model.multi
             else model.decoder(y[:, 0], mem[:, 0])[:, None])
        return model.lm_head(h).to(torch.float32).numpy()


def greedy_pair(jb, params, model, mem):
    """Greedy tokens of both models decoding JAX's memory."""
    ids_j = np.asarray(japi._decode_batch(jb.model, params, mem,
                                          japi._cross_kv_batch(jb.model, params, mem),
                                          DECODE_LEN, None))
    with torch.no_grad():
        ids_p = greedy_decode(model, to_port(mem), DECODE_LEN).numpy()
    return ids_j, ids_p


def encoder_outputs(jb, params, model, feats):
    """The encoders' outputs (before the projection, which rounds to bf16
    on both sides where the two frameworks may differ by an ulp)."""
    want = np.asarray(jb.model.apply(params, jnp.asarray(feats),
                                     method=lambda m, f: m.encoder(f)))
    with torch.no_grad():
        return model.encoder(torch.from_numpy(feats)).numpy(), want


@pytest.fixture(scope="module")
def sources():
    """The JAX bundle each file is written from (seed 0) and the JAX bundle
    each is imported into (the same model with zero weights)."""
    out = {}
    for name, spec in MODELS.items():
        src = jax_bundle(*spec, seed=0)
        zeros = jax.tree_util.tree_map(jnp.zeros_like, src.params)
        out[name] = (src, dataclasses.replace(src, params=zeros))
    return out


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", list(MODELS))
def test_import_checkpoint_matches_jax(tmp_path, sources, name, form, capsys):
    """Both importers load the same file completely (the same report
    line): the encoders agree, and on JAX's memory the decoders give equal
    fp32 logits and equal greedy tokens."""
    src, target = sources[name]
    path = reference_file(tmp_path, src, form)
    params = import_torch.import_checkpoint(path, target.params, require_complete=True)
    jax_report = capsys.readouterr().out
    model = port_model(*MODELS[name], seed=5)
    import_reference.import_checkpoint(path, model, require_complete=True)
    assert capsys.readouterr().out == jax_report
    feats, labels = inputs(src)
    enc_p, enc_j = encoder_outputs(target, params, model, feats)
    mem = jax_memory(target, params, feats)
    want = jax_logits(target, params, mem, labels)
    got = port_logits(model, to_port(mem), labels)
    errs = np.abs(enc_p - enc_j).max(), np.abs(got - want).max()
    print(f"{name} {form}: max |diff| encoder {errs[0]:.2e}, logits {errs[1]:.2e}")
    assert max(errs) <= TOL_LOGITS
    ids_j, ids_p = greedy_pair(target, params, model, mem)
    np.testing.assert_array_equal(ids_p, ids_j)


def test_map_state_dict_reports_what_jax_reports(sources):
    """Unmatched keys, in order, are JAX's: a stray tensor, a prefix the
    importers strip only in their order (module.model.), and a T5 layer's
    MoE tensors (a port-only name, which no reference carries)."""
    src, _ = sources["moe_flagship"]
    sd = import_torch.reference_style_state_dict(src.params)
    sd["model.stray.weight"] = np.zeros((2, 2), np.float32)
    sd["module.model.lm_head.weight"] = sd["model.lm_head.weight"]
    sd["model.encoder.block.0.layer.1.DenseReluDense.router.weight"] = np.zeros(
        (8, 4), np.float32)
    jmapped, junmatched = import_torch.map_state_dict(sd)
    pmapped, punmatched = import_reference.map_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    assert punmatched == junmatched and len(punmatched) == 3
    assert len(pmapped) == len(jmapped)


@pytest.mark.parametrize("defect", ["stray_key", "missing_tensor", "stray_and_missing",
                                    "complete"])
def test_require_complete_raises_where_jax_raises(tmp_path, sources, defect):
    """require_complete raises on exactly the files where JAX's raises;
    without it both import what matched."""
    src, target = sources["t5_tiny"]
    sd = import_torch.reference_style_state_dict(src.params)
    if defect in ("stray_key", "stray_and_missing"):
        sd["model.encoder.extra.weight"] = np.ones((3,), np.float32)
    if defect in ("missing_tensor", "stray_and_missing"):
        del sd["model.decoder.final_layer_norm.weight"]
    path = os.path.join(str(tmp_path), "t.ckpt")
    write_ckpt(path, sd)
    raised = []
    for run in (lambda: import_torch.import_checkpoint(path, target.params, verbose=False,
                                                       require_complete=True),
                lambda: import_reference.import_checkpoint(
                    path, port_model(*MODELS["t5_tiny"], seed=5), verbose=False,
                    require_complete=True)):
        try:
            run()
            raised.append(None)
        except ValueError as e:
            raised.append(str(e).split(":")[0])
    assert raised[0] == raised[1]
    assert (raised[0] is None) == (defect == "complete")
    model = port_model(*MODELS["t5_tiny"], seed=5)
    import_reference.import_checkpoint(path, model, verbose=False)
    want = torch.from_numpy(np.array(sd["model.lm_head.weight"]))
    assert torch.equal(model.lm_head.weight, want)


def test_shape_mismatch_raises_in_both(tmp_path, sources):
    src, target = sources["t5_tiny"]
    sd = import_torch.reference_style_state_dict(src.params)
    sd["model.lm_head.weight"] = sd["model.lm_head.weight"][:, :-1]
    path = os.path.join(str(tmp_path), "bad.ckpt")
    write_ckpt(path, sd)
    with pytest.raises(ValueError, match="shape"):
        import_torch.import_checkpoint(path, target.params, verbose=False)
    with pytest.raises(ValueError, match="lm_head.weight: shape"):
        import_reference.import_checkpoint(path, port_model(*MODELS["t5_tiny"], seed=5),
                                           verbose=False)


def test_reference_style_state_dict_round_trips(sources):
    """The port's inverse writes names its importer maps back, in both
    expert layouts, and they are JAX's names."""
    model = port_model(*MODELS["moe_flagship"], seed=0)
    for per_expert in (False, True):
        sd = import_reference.reference_style_state_dict(model, per_expert=per_expert)
        other = port_model(*MODELS["moe_flagship"], seed=1)
        import_reference.import_state_dict(sd, other, verbose=False, require_complete=True)
        for k, v in model.state_dict().items():
            assert torch.equal(other.state_dict()[k], v), k
    jsd = import_torch.reference_style_state_dict(sources["moe_flagship"][0].params)
    assert sorted(import_reference.reference_style_state_dict(model)) == sorted(jsd)


# ---------------------------------------------------------------------------
# the Orbax bridge
# ---------------------------------------------------------------------------

def run_recipe(ckpt_dir):
    """The export recipe as a shell splits it (shlex, POSIX rules) into
    `python -c <code> <dir>`, its code run in this interpreter with the
    directory as its argument (a second interpreter would pay the JAX
    import and Orbax's start again)."""
    argv = shlex.split(EXPORT_RECIPE.replace("<checkpoint dir>", shlex.quote(ckpt_dir)))
    assert argv[:2] == ["python", "-c"] and argv[3:] == [ckpt_dir], argv
    saved = sys.argv
    sys.argv = ["-c", ckpt_dir]
    try:
        exec(argv[2], {})
    finally:
        sys.argv = saved


@pytest.fixture(scope="module")
def orbax_dirs(tmp_path_factory, sources):
    """JAX save_bundle checkpoints of both models, exported by the recipe;
    the flagship's metadata first loses encoder_abs_pos (a checkpoint
    written before the field existed)."""
    root = tmp_path_factory.mktemp("orbax")
    out = {}
    for name, (src, _) in sources.items():
        d = str(root / name)
        jax_save_bundle(d, src, step=3)
        out[name] = d
    meta_path = os.path.join(out["moe_flagship"], "ymt3_meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    del meta["model"]["encoder_abs_pos"]
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    for d in out.values():
        run_recipe(d)
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_orbax_checkpoint_restores_through_the_recipe(orbax_dirs, name, capsys):
    """JAX save_bundle → the recipe → the port's load_checkpoint gives JAX
    restore_bundle's config (the flagship's missing encoder_abs_pos
    restores as "none" on both sides) and its logits."""
    d = orbax_dirs[name]
    assert os.path.isdir(os.path.join(d, "params"))
    assert os.path.exists(os.path.join(d, REFERENCE_EXPORT))
    jb = jax_restore_bundle(d)
    jax_notes = capsys.readouterr().out
    pb = load_checkpoint(d, device="cpu")
    assert capsys.readouterr().out == jax_notes
    assert pb.cfg == pb.cfg.__class__(**{k: getattr(jb.cfg, k)
                                         for k in pb.cfg.__dataclass_fields__})
    if name == "moe_flagship":
        assert pb.cfg.encoder_abs_pos == "none" and "pre-encoder_abs_pos" in jax_notes
    feats, labels = inputs(jb)
    enc_p, enc_j = encoder_outputs(jb, jb.params, pb.model, feats)
    mem = jax_memory(jb, jb.params, feats)
    err = max(np.abs(enc_p - enc_j).max(),
              np.abs(port_logits(pb.model, to_port(mem), labels)
                     - jax_logits(jb, jb.params, mem, labels)).max())
    assert err <= TOL_LOGITS, err


def test_orbax_checkpoint_without_the_export_names_the_recipe(orbax_dirs, tmp_path):
    d = str(tmp_path / "bare")
    shutil.copytree(orbax_dirs["t5_tiny"], d)
    os.remove(os.path.join(d, REFERENCE_EXPORT))
    with pytest.raises(FileNotFoundError) as err:
        load_checkpoint(d, device="cpu")
    assert EXPORT_RECIPE in str(err.value)


@pytest.mark.parametrize("case", ["perceiver_without_key", "perceiver_with_key",
                                  "conformer_sinusoidal", "t5_without_key"])
def test_restore_meta_rules_match_jax(tmp_path, sources, case, capsys):
    """A port checkpoint and a JAX one carry the same metadata (without
    encoder_abs_pos where the case says so): the port's restore_bundle
    rebuilds the config JAX's rebuilds, printing JAX's note or warning."""
    model = {"perceiver_without_key": "moe_flagship", "perceiver_with_key": "moe_flagship",
             "conformer_sinusoidal": None, "t5_without_key": "t5_tiny"}[case]
    if model is None:
        preset, task, ov = ("conformer_small", "mt3_full_plus_256", dict(
            d_model=64, d_kv=16, num_heads=4, d_ff=128, num_encoder_layers=1,
            num_decoder_layers=1, encoder_abs_pos="sinusoidal"))
        jb = jax_bundle(preset, task, ov, seed=0)
    else:
        (preset, task, ov), jb = MODELS[model], sources[model][0]
    dj, dp = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_save_bundle(dj, jb)
    save_bundle(dp, init_model(preset, task, audio_cfg=AudioConfig(**SMALL),
                               device="cpu", compute_dtype="float32", **ov))
    with open(os.path.join(dj, "ymt3_meta.json")) as f:
        meta = json.load(f)
    if case.endswith("without_key"):
        del meta["model"]["encoder_abs_pos"]
    for d in (dj, dp):
        with open(os.path.join(d, "ymt3_meta.json"), "w") as f:
            json.dump(meta, f)
    capsys.readouterr()
    jcfg = jax_restore_bundle(dj).cfg
    jax_notes = capsys.readouterr().out
    pcfg = load_checkpoint(dp, device="cpu").cfg
    assert capsys.readouterr().out == jax_notes
    assert {k: getattr(jcfg, k) for k in pcfg.__dataclass_fields__} == \
        {k: getattr(pcfg, k) for k in pcfg.__dataclass_fields__}
    want = {"perceiver_without_key": "none", "perceiver_with_key": "sinusoidal",
            "conformer_sinusoidal": "sinusoidal", "t5_without_key": "sinusoidal"}[case]
    assert pcfg.encoder_abs_pos == want
    assert ("pre-encoder_abs_pos" in jax_notes) == (case == "perceiver_without_key")
    assert ("warning: conformer" in jax_notes) == (case == "conformer_sinusoidal")
