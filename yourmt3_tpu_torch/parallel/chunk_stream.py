"""Chunk-parallel full-song streaming over the ranks of a process group
(the JAX package's `parallel/chunk_stream.py`).

The JAX package shards a song's segment axis over its mesh's `data`
axis and decodes every chunk in one program. Here each rank encodes and
greedy-decodes its own slice of each tile of segments on its own card,
through the port's decode (the int4 cross kernel for the flagship, the
paged kernel on t5_small's fast path), and the token ids are all-gathered
in segment order. Every rank then detokenizes the same ids, so every rank
returns the same notes and errors.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..api import ModelBundle, _encode_batch
from ..data.audio_io import slice_padded_array
from ..models.decoding import greedy_decode
from ..tokens.dataclasses import Note
from ..tokens.event2note import DecodeErrors
from .mesh import all_gather_rows, data_group, rank, world_size


@torch.no_grad()
def transcribe_song_chunk_parallel(
    bundle: ModelBundle,
    audio: np.ndarray,  # full song, mono float32 @ bundle sample rate
    mesh=None,
    subtask: Optional[str] = None,
    segments_per_device: int = 8,
    max_length: Optional[int] = None,
) -> Tuple[List[Note], DecodeErrors]:
    """Decode a song's segments over the ranks of `mesh` (a process group;
    None: the default group, or one process when there is none).
    → (merged notes, decode errors), the same on every rank.

    The segment count is padded with silent segments to a multiple of
    world × segments_per_device, so every rank decodes batches of
    `segments_per_device`; max_length caps the decode length (default: the
    task's full token budget)."""
    group = data_group(mesh)
    n, r = world_size(group), rank(group)
    ac = bundle.audio_cfg
    tm = bundle.task_manager

    segments, starts = slice_padded_array(audio, ac.input_frames)
    S = segments.shape[0]
    tile = n * segments_per_device
    S_pad = -(-S // tile) * tile
    if S_pad != S:
        segments = np.concatenate(
            [segments, np.zeros((S_pad - S, ac.input_frames), np.float32)])

    prefix = tm.subtask_prefix_ids(subtask)
    L = tm.max_token_length if max_length is None else min(
        max_length, tm.max_token_length)
    out_ids = []
    for i in range(0, S_pad, tile):
        lo = i + r * segments_per_device
        chunk = np.ascontiguousarray(segments[lo:lo + segments_per_device],
                                     dtype=np.float32)
        memory = _encode_batch(bundle, chunk)
        ids = greedy_decode(bundle.model, memory, L, prefix_ids=prefix,
                            cross_kvs=bundle.model.init_cross_kv(memory))
        out_ids.append(all_gather_rows(ids, group))
    ids = torch.cat(out_ids)[:S]  # (S, C, L), in segment order
    return tm.detokenize_song(ids, (starts / ac.sample_rate).tolist())
