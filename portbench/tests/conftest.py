"""The benchmark's tests: this directory (the tiny cells, `pb_tiny`) and
portbench/ on the path (as `python3 portbench/run.py` has it), the port's
root after them, and the marker of the tests that need a CUDA card."""

import os
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(TESTS)
for path in (os.path.dirname(BENCH), BENCH, TESTS):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one.")
