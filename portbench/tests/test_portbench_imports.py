"""No module that the benchmark loads imports JAX, its libraries or the
JAX package: top-level module names compared whole, since the port's name
begins with the JAX package's."""

import ast
import os
import subprocess
import sys

from harness import core

SOURCES = [os.path.join(d, f) for d, _, fs in os.walk(core.BENCH_DIR)
           for f in fs if f.endswith(".py")]


def imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_a_banned_module():
    for path in SOURCES:
        if os.sep + "tests" + os.sep in path:
            continue
        assert not set(imported_tops(path)) & set(core.BANNED), path


def test_reference_imports_nothing_of_the_port():
    ref_dir = os.path.join(core.BENCH_DIR, "reference")
    for path in SOURCES:
        if path.startswith(ref_dir):
            assert "yourmt3_tpu_torch" not in set(imported_tops(path)), path


def test_a_run_loads_no_banned_module():
    """A tiny run of each kind of cell on the CPU, in a fresh process, then
    sys.modules by whole top-level names."""
    code = (
        "import sys, time, torch\n"
        f"sys.path[:0] = [{os.path.dirname(__file__)!r}, {core.BENCH_DIR!r}, {core.REPO!r}]\n"
        "torch.set_num_threads(2)\n"
        "from pb_tiny import tiny_cell\n"
        "from harness import core\n"
        "import run, calibrate\n"
        "for name in ('mc13.transcribe', 'moe.train'):\n"
        "    cell = tiny_cell(name, **({'song_seconds': 2.0} if 'transcribe' in name else {}))\n"
        "    core.driver(cell).run(cell, 3, 0.0, False, torch.device('cpu'), time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(core.banned_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    tops, banned = out.stdout.strip().splitlines()[-2:]
    assert banned == "[]", tops
    assert "yourmt3_tpu_torch" in tops
