"""Build and load the port's hand-written CUDA kernels as PyTorch operators.

Each kernel under `ops/csrc/` (`<name>.cu`) keeps a plain C launch
function, declared with the kernels' limits in `csrc/kernels.h`, and
includes no torch header. `csrc/torch_ops.cpp`, the one translation unit
that includes torch's headers, checks the arguments and registers the
operators `torch.ops.yourmt3_tpu_torch.<name>` for CUDA. At first use
every stale source is compiled with `nvcc -c` (the kernels for sm_90a),
all compiles started together, and `nvcc` links the objects with torch's
libraries into one library, `yourmt3_tpu_torch/build/libyourmt3_ops.so`
(listed in .gitignore), which `torch.ops.load_library` loads once.

An object newer than its source and than `kernels.h` is reused, and so is
a library newer than every object, so editing a kernel does not recompile
the torch headers. A stamp beside the library records the toolchain: the
version of torch, the output of `nvcc --version` and the build's command
lines (flags, include and library paths, the ABI define). When it
differs, every source recompiles. Nothing here runs at import time, and
nothing falls back: a failed build or load raises.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
from typing import List

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build")
KERNELS = ("paged_decode_attention", "int4_cross_attention", "int8_decode_attention",
           "int8_linear", "fused_logmel", "launch_probe")
BINDING = "torch_ops"
HEADER = "kernels.h"
LIBRARY = os.path.join(BUILD_DIR, "libyourmt3_ops.so")
NAMESPACE = "yourmt3_tpu_torch"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
CU_FLAGS = ["-O3", "-std=c++17", *ARCH, "-Xcompiler", "-fPIC"]
CXX_FLAGS = ["-O2", "-std=c++20", "-Xcompiler", "-fPIC"]
TORCH_LIBS = ["c10", "c10_cuda", "torch", "torch_cpu", "torch_cuda"]

_loaded = False


def nvcc_path() -> str:
    cand = shutil.which("nvcc")
    if cand:
        return cand
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build with the CUDA "
                       "toolkit's nvcc (PATH or CUDA_HOME)")


def _source(name: str) -> str:
    return os.path.join(CSRC, name + (".cpp" if name == BINDING else ".cu"))


def _object(name: str) -> str:
    return os.path.join(BUILD_DIR, name + ".o")


def _torch_flags():
    """(include flags, ABI define, link flags) of the installed torch; the
    CUDA headers come from nvcc's own toolkit."""
    import torch
    from torch.utils.cpp_extension import include_paths, library_paths
    cuda_include = os.path.join(os.path.dirname(os.path.dirname(nvcc_path())),
                                "include")
    includes = [f"-I{p}" for p in [*include_paths(), cuda_include]]
    abi = f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"
    lib = library_paths()[0]
    link = [f"-L{lib}", *(f"-l{n}" for n in TORCH_LIBS), "-Xlinker", f"-rpath,{lib}"]
    return includes, abi, link


def build_commands() -> List[List[str]]:
    """The compile command of each source (kernels, then the binding), then
    the link command into LIBRARY. Each writes `<output>.tmp`, renamed
    when it succeeds."""
    nvcc = nvcc_path()
    includes, abi, link = _torch_flags()
    compiles = [[nvcc, *CU_FLAGS, "-c", _source(n), "-o", _object(n) + ".tmp"]
                for n in KERNELS]
    compiles.append([nvcc, *CXX_FLAGS, abi, *includes, "-c", _source(BINDING),
                     "-o", _object(BINDING) + ".tmp"])
    objects = [_object(n) for n in (*KERNELS, BINDING)]
    return compiles + [[nvcc, "-shared", *ARCH, *objects, *link, "-o",
                        LIBRARY + ".tmp"]]


def _newer(path: str, than: str) -> bool:
    return os.path.exists(path) and os.path.getmtime(path) >= os.path.getmtime(than)


def _stamp(cmds: List[List[str]]) -> str:
    """The toolchain the objects were built with: torch's version, nvcc's
    own report of its version, and the command lines."""
    import torch
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip()
    return json.dumps({"torch": str(torch.__version__), "nvcc": nvcc,
                       "commands": cmds}, indent=1)


def _read(path: str) -> str:
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def _run_all(cmds: List[List[str]]) -> None:
    """Run the commands together; rename each one's output when it
    succeeds, then raise with the log of each that failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = []
    for cmd, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{' '.join(cmd)} (exit {p.returncode}):\n{log}")
        else:
            out = cmd[cmd.index("-o") + 1]
            os.replace(out, out[:-len(".tmp")])
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))


def build() -> str:
    """Compile every stale source (all at once; every source when the
    toolchain's stamp differs), link if any object is newer than the
    library; → the library's path."""
    names = (*KERNELS, BINDING)
    cmds = build_commands()
    stamp, stamp_path = _stamp(cmds), LIBRARY + ".stamp"
    same = _read(stamp_path) == stamp
    header = os.path.join(CSRC, HEADER)
    stale = [i for i, n in enumerate(names)
             if not (same and _newer(_object(n), _source(n)) and _newer(_object(n), header))]
    if not stale and all(_newer(LIBRARY, _object(n)) for n in names):
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    *compiles, link = cmds
    _run_all([compiles[i] for i in stale])
    _run_all([link])
    with open(stamp_path + ".tmp", "w") as f:
        f.write(stamp)
    os.replace(stamp_path + ".tmp", stamp_path)
    return LIBRARY


def load() -> None:
    """Build if needed and load the operators, once per process."""
    global _loaded
    if not _loaded:
        import torch
        torch.ops.load_library(build())
        _loaded = True


def op(name: str):
    """The loaded operator `torch.ops.yourmt3_tpu_torch.<name>` (its only
    overload)."""
    import torch
    load()
    return getattr(getattr(torch.ops, NAMESPACE), name).default
