"""The PyTorch port and chip_smoke.py import nothing of JAX or of the JAX
package, and the port's entry points refuse to run on a host without
CUDA unless the caller asks for the CPU."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "yourmt3_tpu"}


def _port_files():
    files = sorted((ROOT / "yourmt3_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_jax_imports_anywhere_in_the_port():
    files = _port_files()
    assert len(files) > 20 and all(f.exists() for f in files)
    bad = {(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN}
    assert not bad, sorted(bad)


def test_no_ctypes_in_the_kernel_ops():
    """The kernels launch through registered PyTorch operators, not ctypes."""
    files = sorted((ROOT / "yourmt3_tpu_torch" / "ops").rglob("*.py"))
    assert len(files) > 5
    bad = [str(f.relative_to(ROOT)) for f in files if "ctypes" in set(_imported_roots(f))]
    assert not bad, bad


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.cli import train as cli_train
    from yourmt3_tpu_torch.cli import transcribe as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.init_model("t5_tiny", "mt3_full_plus_256")
    wav = tmp_path / "x.wav"
    wav.write_bytes(b"")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([str(wav), "-m", "t5_tiny", "-o", str(tmp_path)])
    monkeypatch.setenv("YMT3_DATA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(["exp", "-m", "t5_tiny", "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("flag", ["-ckpt", "--url"])
def test_cli_rejects_unported_inputs(tmp_path, flag):
    """--url is not ported; -ckpt is, and a directory that holds no
    checkpoint is refused."""
    from yourmt3_tpu_torch.cli import transcribe as cli
    if flag == "--url":
        with pytest.raises(SystemExit, match="not yet ported"):
            cli.main(["a.wav", flag, str(tmp_path)])
    else:
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            cli.main(["a.wav", flag, str(tmp_path)])


def test_unported_options_raise():
    """What the port does not carry yet raises, naming its ROADMAP item:
    the MoE flagship, the conformer encoder, the non-identity projections
    of the T5 encoder, the rope/alibi Perceiver positions, the
    D-Adaptation optimizer and data-parallel training."""
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.train.optim import make_optimizer
    from yourmt3_tpu_torch.train.trainer import train
    cases = [("perceiver_tf_mc13_moe", "mc13_full_plus_256", {}),
             ("conformer_small", "mt3_full_plus_256", {}),
             ("t5_tiny", "mt3_full_plus_256", {"proj_type": "mlp"}),
             ("perceiver_tf_mc13", "mc13_full_plus_256",
              {"ptf_pos_enc": "rope"})]
    for preset, task, ov in cases:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            api.init_model(preset, task, device="cpu", **ov)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_optimizer("dadapt_adam")
    bundle = api.init_model("t5_tiny", "mt3_full_plus_256", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train(bundle, iter(()), n_data_shards=2)
