"""The PyTorch port and chip_smoke.py import nothing of JAX or of the JAX
package, and the port's entry points refuse to run on a host without
CUDA unless the caller asks for the CPU."""

import ast
import pathlib
import sys
import types

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
    from yourmt3_tpu_torch.cli import test as cli_test
    from yourmt3_tpu_torch.cli import train as cli_train
    from yourmt3_tpu_torch.cli import transcribe as cli
    from yourmt3_tpu_torch.eval.evaluator import evaluate_file_dataset
    from yourmt3_tpu_torch.train.checkpoint import save_bundle

    ckpt = tmp_path / "ckpt"
    save_bundle(str(ckpt), api.init_model("t5_tiny", "mt3_full_plus_256",
                                          device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_test.main(["-ckpt", str(ckpt)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        # a bundle placed on the CUDA device
        evaluate_file_dataset(types.SimpleNamespace(device=torch.device("cuda")), [])
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
def test_cli_rejects_unported_inputs(tmp_path, flag, monkeypatch):
    """A directory that holds no checkpoint is refused; --url without
    yt-dlp installed exits naming it, as the JAX CLI does (with yt-dlp it
    runs: tests/test_torch_tooling.py)."""
    from yourmt3_tpu_torch.cli import transcribe as cli
    if flag == "--url":
        monkeypatch.setitem(sys.modules, "yt_dlp", None)
        with pytest.raises(SystemExit, match="yt-dlp"):
            cli.main([flag, "https://youtu.be/x", "-o", str(tmp_path)])
    else:
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            cli.main(["a.wav", flag, str(tmp_path)])


def test_unported_options_raise(tmp_path):
    """What the port does not carry yet raises, naming its ROADMAP item:
    an Orbax checkpoint of the JAX package. (D-Adaptation, data-parallel
    training and the evaluator's mesh run: tests/test_torch_dadapt.py,
    tests/test_torch_parallel.py; every encoder and option of ModelConfig
    builds: tests/test_torch_encoder_options.py.)"""
    from yourmt3_tpu_torch import api
    orbax = tmp_path / "orbax"
    (orbax / "params").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 13"):
        api.load_checkpoint(str(orbax), device="cpu")
