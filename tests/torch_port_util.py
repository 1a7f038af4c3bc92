"""Shared set-up for the PyTorch port's parity tests: the same model built
by the JAX package and by the port, with the JAX weights bridged into the
port through `state_dict_from_jax`. Both run on the CPU in fp32."""

import numpy as np
import pytest
import torch

import jax

from yourmt3_tpu.api import init_model as jax_init_model
from yourmt3_tpu_torch.api import init_model as port_init_model
from yourmt3_tpu_torch.weights import state_dict_from_jax


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Autouse in the modules that import it: torch runs one intra-op
    thread there. Their decode loops are thousands of tiny ops, and when
    the parallel test run's workers share the cores, each op's thread
    barrier waits on threads of other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def numpy_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def bridged_bundles(preset="t5_tiny", task="mt3_full_plus_256", seed=0,
                    **overrides):
    """→ (JAX bundle, port bundle) with identical fp32 weights on the CPU."""
    jb = jax_init_model(preset, task, seed=seed, compute_dtype="float32",
                        **overrides)
    pb = port_init_model(preset, task, device="cpu", compute_dtype="float32",
                         **overrides)
    pb.model.load_state_dict(state_dict_from_jax(numpy_params(jb.params)),
                             strict=True)
    return jb, pb


def sine_song(seconds: float, sample_rate: int = 16000,
              seed: int = 0) -> np.ndarray:
    """A mono float32 mixture of a few sines with note-like envelopes over
    a noise floor. The floor keeps every mel bin well above the log
    offset: a bin near it would carry mostly fp32 rounding, which the
    two frameworks round differently."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    audio = np.zeros_like(t)
    for f0 in rng.uniform(110.0, 880.0, size=6):
        start = rng.uniform(0, seconds * 0.8)
        env = np.clip((t - start) * 20.0, 0, 1) * np.exp(-np.clip(t - start, 0, None))
        audio += 0.2 * env * np.sin(2 * np.pi * f0 * t)
    audio += 0.02 * rng.standard_normal(t.shape)
    return audio.astype(np.float32)
