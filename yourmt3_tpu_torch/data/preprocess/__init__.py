"""Datasets → the index format of data/indexes.py: the synthetic corpus
(synth.py) and the per-dataset converters of native annotations
(converters.py), which cli/install_dataset.py runs after an optional
download (data/download.py)."""

from . import synth  # noqa: F401
