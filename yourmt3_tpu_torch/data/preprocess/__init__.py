"""Dataset builders → the index format of data/indexes.py. The port
carries the synthetic corpus builder (synth.py); the per-dataset
converters stay in the JAX package for now."""

from . import synth  # noqa: F401
