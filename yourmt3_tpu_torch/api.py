"""Public inference API: init_model(...) + transcribe(audio) → MIDI.

load → resample to 16 kHz mono → slice into segments → batch → frontend
→ encoder → greedy decode → detokenize (on the device of the decoded
ids) and merge → MIDI file. Segments are batched to a fixed batch size
(zero-padded) so every batch has one shape.

The entry points run on the CUDA device by default and raise when there
is none; the CPU is used only when the caller passes device="cpu".
A bundle gets its weights from `init_model` (random, from a seed), from
`load_checkpoint` (the port's checkpoint format, train/checkpoint.py) or
from `weights.state_dict_from_jax`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config.audio import AudioConfig, DEFAULT_AUDIO
from .config.model import ModelConfig, get_model_config
from .data.audio_io import load_audio_file, resample, slice_padded_array
from .models.decoding import (beam_decode, greedy_decode,
                               greedy_decode_early_exit)
from .models.ymt3 import YMT3
from .ops.frontend import SpectrogramFrontend
from .tokens.dataclasses import Note
from .tokens.event2note import DecodeErrors, per_segment_error_counts
from .tokens.midi_io import note_event2midi
from .tokens.task_manager import TaskManager
from .utils import profiling


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA device; raise when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller asks "
            "for the CPU explicitly (device='cpu', or --cpu on the CLI)")
    return dev


@dataclasses.dataclass
class ModelBundle:
    """Everything needed to transcribe: model + frontend + task."""

    model: YMT3
    frontend: SpectrogramFrontend
    task_manager: TaskManager
    audio_cfg: AudioConfig

    @property
    def cfg(self) -> ModelConfig:
        return self.model.cfg

    @property
    def device(self) -> torch.device:
        return self.model.shared.weight.device

    def with_decode_overrides(self, **overrides) -> "ModelBundle":
        """Switch the decode path (kv_quant / use_pallas_decode / ...) and
        keep the weights: the model is rebuilt with the new config and the
        same parameters, and the decoder's side-car weights follow the new
        weight_quant mode (ops/weight_quant.py). Mutates and returns self."""
        cfg = self.cfg.replace(**overrides)
        model = YMT3(cfg, self.audio_cfg.num_feature_bins).to(self.device)
        model.load_state_dict(self.model.state_dict(), strict=True)
        self.model = model.eval()
        return self


def fast_decode_overrides(num_channels: int, max_len: int) -> dict:
    """The fast decode path per shape: multi-channel or short decodes →
    int8 dense KV; single-channel long decodes → the int8 paged kernel.
    Both int8 kernels read only the rows up to the position; the paged
    one stays on the long single-channel decode (t5_small's 1024 steps of
    a few streams), where the dense kernel was never timed. Use
    kv_quant="none" for exact outputs."""
    if num_channels > 1 or max_len < 512:
        return {"kv_quant": "int8"}
    return {"kv_quant": "int8", "use_pallas_decode": True}


def init_model(model_preset: str = "t5_small", task: str = "mt3_full_plus",
               audio_cfg: AudioConfig = DEFAULT_AUDIO, seed: int = 0,
               model_cfg: Optional[ModelConfig] = None, device=None,
               **cfg_overrides) -> ModelBundle:
    """Build a randomly-initialized bundle on `device` (default: CUDA).

    The weights are drawn on the CPU from a torch.Generator seeded with
    `seed`, so a seed gives the same model on every device. With
    weight_quant="bf16" or "int8" the decoder also carries the side-car
    weights derived from them."""
    dev = resolve_device(device)
    tm = TaskManager(task, audio_cfg)
    cfg = (model_cfg or get_model_config(model_preset)).replace(
        vocab_size=tm.vocab_size,
        num_channels=tm.num_decoding_channels,
        max_target_length=tm.max_token_length,
        **cfg_overrides)
    model = YMT3(cfg, audio_cfg.num_feature_bins)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return ModelBundle(model.to(dev).eval(),
                       SpectrogramFrontend(audio_cfg).to(dev), tm, audio_cfg)


def load_checkpoint(path: str, model_preset: Optional[str] = None,
                    task: Optional[str] = None,
                    audio_cfg: Optional[AudioConfig] = None, device=None,
                    **cfg_overrides) -> ModelBundle:
    """Restore a bundle from a checkpoint directory written by
    train/checkpoint.py (its metadata carries the preset, the task and the
    full audio and model configs; explicit arguments win). cfg_overrides
    pass decode-time ModelConfig fields through, e.g. kv_quant="int8c4p",
    weight_quant="int8": the side-car weights are built from the restored
    masters."""
    from .train.checkpoint import restore_bundle
    return restore_bundle(path, model_preset=model_preset, task=task,
                          audio_cfg=audio_cfg, device=device, **cfg_overrides)


# ---------------------------------------------------------------------------

def _encode_batch(bundle: ModelBundle, audio: np.ndarray) -> torch.Tensor:
    with profiling.span("encode"):
        feats = bundle.frontend(torch.from_numpy(audio).to(bundle.device))
        return bundle.model.encode(feats)


def _padded_batches(segments: np.ndarray, rows: Sequence[int],
                    batch_size: int, input_frames: int):
    """Yield (row indices, (batch_size, input_frames) zero-padded audio)."""
    for i in range(0, len(rows), batch_size):
        block = list(rows[i: i + batch_size])
        chunk = segments[block]
        pad_n = batch_size - chunk.shape[0]
        if pad_n:
            chunk = np.concatenate(
                [chunk, np.zeros((pad_n, input_frames), np.float32)])
        yield block, np.ascontiguousarray(chunk, dtype=np.float32)


@torch.no_grad()
def transcribe_segments_array(
    bundle: ModelBundle, segments: np.ndarray, start_times: Sequence[float],
    batch_size: int = 8, subtask: Optional[str] = None,
    early_exit: bool = False, decode_phases: int = 1, beam_size: int = 1,
    repetition_guard: int = 0, repair_beam: int = 0,
) -> Tuple[List[Note], DecodeErrors]:
    """Pre-sliced (S, input_frames) segments + their start times → merged
    notes. beam_size > 1 decodes every segment with beam search;
    early_exit=True decodes with per-stream retirement
    (models/decoding.greedy_decode_early_exit, the same tokens); the two
    exclude each other.

    repair_beam > 1 runs validate-and-repair decode: after the greedy
    pass, only the segments the detokenizer's merge walk implicates are
    re-decoded with beam search of that width, and the repaired ids are
    kept only if they strictly reduce the total detokenizer errors."""
    if beam_size > 1 and early_exit:
        raise ValueError("beam_size>1 and early_exit are mutually exclusive")
    if repetition_guard > 0 and (beam_size > 1 or early_exit):
        raise ValueError(
            "repetition_guard>0 is only supported on the plain greedy path "
            "(not beam_size>1 or early_exit) — drop one of the flags")
    with profiling.request("transcribe"):
        ac = bundle.audio_cfg
        tm = bundle.task_manager
        prefix = tm.subtask_prefix_ids(subtask)
        L = tm.max_token_length
        S = segments.shape[0]

        all_ids = []
        for block, chunk in _padded_batches(segments, range(S), batch_size,
                                            ac.input_frames):
            memory = _encode_batch(bundle, chunk)
            if beam_size > 1:
                ids = beam_decode(bundle.model, memory, L, beam_size=beam_size,
                                  prefix_ids=prefix)
            else:
                with profiling.span("cross_kv"):
                    cross_kvs = bundle.model.init_cross_kv(memory)
                if early_exit:
                    ids = greedy_decode_early_exit(bundle.model, memory, L,
                                                   prefix_ids=prefix,
                                                   cross_kvs=cross_kvs)
                else:
                    ids = greedy_decode(bundle.model, memory, L, prefix_ids=prefix,
                                        phases=decode_phases, cross_kvs=cross_kvs,
                                        repetition_guard=repetition_guard)
            all_ids.append(ids[: len(block)])
            # the block's memory and cross K/V are dead: not held through
            # the next block's encode and the repair's beam search
            memory = cross_kvs = None
        seg_ids = torch.cat(all_ids)  # (S, C, L) on the device
        notes, errors = tm.detokenize_song(seg_ids, list(start_times))
        if repair_beam > 1 and beam_size == 1 and errors.total() > 0:
            repaired = _repair_error_segments(bundle, segments,
                                              seg_ids.cpu().numpy(),
                                              list(start_times), prefix, L,
                                              batch_size, repair_beam)
            if repaired is not None:
                notes2, errors2 = tm.detokenize_song(repaired, list(start_times))
                if errors2.total() < errors.total():
                    notes, errors = notes2, errors2
        return notes, errors


def _repair_error_segments(
    bundle: ModelBundle, segments: np.ndarray, seg_ids: np.ndarray,
    start_times: List[float], prefix: List[int], L: int, batch_size: int,
    beam: int) -> Optional[np.ndarray]:
    """Beam-re-decode only the segments the detokenizer merge walk flags.

    A `tie_without_active_note` at segment s usually means segment s-1's
    stream lost the onset, so tie errors implicate the merge-order
    predecessor as well as s itself."""
    S, C = seg_ids.shape[0], seg_ids.shape[1]
    chan_ids = [[seg_ids[s, c] for s in range(S)] for c in range(C)]
    with profiling.span("repair.scan"):
        totals, ties = per_segment_error_counts(
            chan_ids, start_times, bundle.task_manager.codec,
            default_programs=bundle.task_manager.channel_default_programs)
    suspects = set(np.nonzero(totals.sum(axis=0))[0].tolist())
    order = sorted(range(S), key=lambda s: start_times[s])
    pos_in_order = {s: i for i, s in enumerate(order)}
    for s in np.nonzero(ties.sum(axis=0))[0].tolist():
        i = pos_in_order[s]
        if i > 0:
            suspects.add(order[i - 1])
    if not suspects:
        return None
    idx = sorted(suspects)
    rows = []
    for block, chunk in _padded_batches(segments, idx, batch_size,
                                        bundle.audio_cfg.input_frames):
        memory = _encode_batch(bundle, chunk)
        ids = beam_decode(bundle.model, memory, L, beam_size=beam,
                          prefix_ids=prefix)
        rows.append(ids.cpu().numpy()[: len(block)])
    repaired = seg_ids.copy()
    repaired[idx] = np.concatenate(rows, axis=0)
    return repaired


def transcribe_audio_array(
    bundle: ModelBundle, audio: np.ndarray, sample_rate: Optional[int] = None,
    batch_size: int = 8, subtask: Optional[str] = None,
    early_exit: bool = False, decode_phases: int = 1, beam_size: int = 1,
    repetition_guard: int = 0, repair_beam: int = 0,
) -> Tuple[List[Note], DecodeErrors]:
    """Full-song mono float32 audio → merged notes (the options are those
    of transcribe_segments_array)."""
    ac = bundle.audio_cfg
    if sample_rate is not None and sample_rate != ac.sample_rate:
        audio = resample(audio, sample_rate, ac.sample_rate)
    segments, starts = slice_padded_array(audio, ac.input_frames)
    return transcribe_segments_array(
        bundle, segments, (starts / ac.sample_rate).tolist(),
        batch_size=batch_size, subtask=subtask, early_exit=early_exit,
        decode_phases=decode_phases, beam_size=beam_size,
        repetition_guard=repetition_guard, repair_beam=repair_beam)


def transcribe(bundle: ModelBundle, audio_path: str,
               output_path: Optional[str] = None, batch_size: int = 8,
               subtask: Optional[str] = None, beam_size: int = 1,
               repetition_guard: int = 0, repair_beam: int = 2) -> str:
    """Audio file → MIDI file path. repair_beam=2 (default) re-decodes the
    segments the detokenizer rejects with beam-2; 0 keeps the raw greedy
    stream."""
    with profiling.span("transcribe"):
        with profiling.span("load_audio"):
            audio, sr = load_audio_file(audio_path, bundle.audio_cfg.sample_rate)
        notes, _ = transcribe_audio_array(bundle, audio, sr, batch_size, subtask,
                                          beam_size=beam_size,
                                          repetition_guard=repetition_guard,
                                          repair_beam=repair_beam)
        if output_path is None:
            output_path = os.path.splitext(audio_path)[0] + ".mid"
        with profiling.span("write_midi"):
            note_event2midi(notes, output_path)
    return output_path
