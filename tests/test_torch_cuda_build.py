"""The build of the port's CUDA kernels into one library of PyTorch
operators (`yourmt3_tpu_torch/ops/cuda_build.py`), checked on the CPU: the
command lines, and which sources a rebuild compiles. A stand-in for nvcc
writes empty outputs and reports the version in the file beside it;
nothing is compiled or loaded here."""

import os
import stat
import sys

import pytest
import torch
from torch.utils.cpp_extension import include_paths, library_paths

from yourmt3_tpu_torch.ops import cuda_build

ARCH = "arch=compute_90a,code=sm_90a"


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """An nvcc that prints the version in `version` beside it, or logs its
    arguments and writes its -o output."""
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    (nvcc.parent / "version").write_text("Cuda compilation tools, release 12.9\n")
    log = tmp_path / "nvcc.log"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import os, sys\n"
        "args = sys.argv[1:]\n"
        "if args == ['--version']:\n"
        "    print(open(os.path.join(os.path.dirname(sys.argv[0]), 'version')).read())\n"
        "    sys.exit(0)\n"
        f"open({str(log)!r}, 'a').write(' '.join(args) + '\\n')\n"
        "open(args[args.index('-o') + 1], 'w').close()\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: str(nvcc))
    return nvcc, log


def test_command_lines(fake_nvcc):
    nvcc, _ = fake_nvcc
    cmds = cuda_build.build_commands()
    *compiles, link = cmds
    assert all(c[0] == str(nvcc) for c in cmds)
    sources = [c[c.index("-c") + 1] for c in compiles]
    assert [os.path.basename(s) for s in sources] == [
        "paged_decode_attention.cu", "int4_cross_attention.cu",
        "int8_decode_attention.cu", "int8_linear.cu", "fused_logmel.cu", "launch_probe.cu",
        "torch_ops.cpp"]
    assert all(os.path.exists(s) for s in sources)
    for c in compiles[:-1]:  # the kernels: sm_90a, no torch header
        assert ARCH in c and "-fPIC" in c
        assert not any(a.startswith("-I") for a in c)
    binding = compiles[-1]
    abi = f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"
    assert abi in binding and "-fPIC" in binding
    for p in include_paths():
        assert f"-I{p}" in binding
    assert f"-I{nvcc.parent.parent / 'include'}" in binding  # the CUDA headers
    # one library, linked by nvcc from every object against torch's libraries
    assert [c for c in cmds if "-shared" in c] == [link]
    assert link[link.index("-o") + 1] == cuda_build.LIBRARY + ".tmp"
    assert cuda_build.LIBRARY.endswith(os.path.join("build", "libyourmt3_ops.so"))
    assert [a for a in link if a.endswith(".o")] == [
        c[c.index("-o") + 1][:-len(".tmp")] for c in compiles]
    lib = library_paths()[0]
    assert f"-L{lib}" in link and f"-rpath,{lib}" in link and ARCH in link
    for name in ("c10", "c10_cuda", "torch", "torch_cpu", "torch_cuda"):
        assert f"-l{name}" in link


@pytest.fixture
def sources(fake_nvcc, tmp_path, monkeypatch):
    """Stand-in sources and build directory; → run(), which builds and
    returns the logged nvcc command lines."""
    _, log = fake_nvcc
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    for n in cuda_build.KERNELS:
        (csrc / f"{n}.cu").write_text("// kernel\n")
    (csrc / "torch_ops.cpp").write_text("// binding\n")
    (csrc / "kernels.h").write_text("// launch functions\n")
    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(build))
    monkeypatch.setattr(cuda_build, "LIBRARY", str(build / "libyourmt3_ops.so"))

    def run():
        log.write_text("")
        assert cuda_build.build() == str(build / "libyourmt3_ops.so")
        return [line.split() for line in log.read_text().splitlines()]

    return run


def test_rebuild_compiles_only_what_changed(sources, tmp_path):
    run, build, csrc = sources, tmp_path / "build", tmp_path / "csrc"
    first = run()
    # a compile per kernel and one for the binding, then the link
    assert len(first) == len(cuda_build.KERNELS) + 2 and "-shared" in first[-1]
    assert (build / "libyourmt3_ops.so").exists()
    assert not list(build.glob("*.tmp"))
    assert run() == []  # everything fresh
    later = os.path.getmtime(build / "libyourmt3_ops.so") + 10
    os.utime(csrc / "paged_decode_attention.cu", (later, later))
    again = run()  # the edited kernel and the link; not the torch unit
    assert len(again) == 2 and "-shared" in again[1]
    assert again[0][again[0].index("-c") + 1].endswith("paged_decode_attention.cu")


def test_failed_compile_raises_and_leaves_no_object(fake_nvcc, tmp_path, monkeypatch):
    nvcc, _ = fake_nvcc
    nvcc.write_text("#!/bin/sh\n[ \"$1\" = --version ] && exit 0\n"
                    "echo 'error: no such intrinsic' >&2\nexit 2\n")
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "LIBRARY", str(tmp_path / "build" / "lib.so"))
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        cuda_build.build()
    assert not list((tmp_path / "build").glob("*.o"))


# what every object depends on: a change to any recompiles every source
@pytest.mark.parametrize("change", ["header", "flags", "nvcc", "torch"])
def test_toolchain_or_header_change_recompiles_everything(sources, fake_nvcc, tmp_path,
                                                          monkeypatch, change):
    run, build = sources, tmp_path / "build"
    assert len(run()) == len(cuda_build.KERNELS) + 2
    assert run() == []
    assert (build / "libyourmt3_ops.so.stamp").exists()
    if change == "header":  # the header edited after the build, the sources before
        now = os.path.getmtime(tmp_path / "csrc" / "kernels.h")
        for path, t in [*((p, now - 100) for p in build.iterdir()),
                        *((p, now - 200) for p in (tmp_path / "csrc").iterdir()
                          if p.name != "kernels.h")]:
            os.utime(path, (t, t))
    elif change == "flags":
        monkeypatch.setattr(cuda_build, "CU_FLAGS", [*cuda_build.CU_FLAGS, "-lineinfo"])
    elif change == "nvcc":
        (fake_nvcc[0].parent / "version").write_text("Cuda compilation tools, release 13.0\n")
    else:
        monkeypatch.setattr(torch, "__version__", "0.0.0+other")
    again = run()
    assert len(again) == len(cuda_build.KERNELS) + 2 and "-shared" in again[-1]
    assert sorted(os.path.basename(c[c.index("-c") + 1]) for c in again[:-1]) == sorted(
        [f"{n}.cu" for n in cuda_build.KERNELS] + ["torch_ops.cpp"])
    assert run() == []  # the new stamp is written
