"""The check of a transcription window against the plain reference.

Every segment of every song the window completed is run once through
reference/model.py (and the configuration's encoder) in float32,
teacher-forced with the tokens the program served for it, and these
numbers are compared:

- `token_gap`: the widest gap, in logits, by which a served token lies
  below the reference's best at its position. A greedy token is held to
  the reference's first, a token of the beam repair to its second (a
  beam of 2 keeps, at every step, one of the two best continuations of
  its parent). Positions after a stream's EOS are not served, and
  neither are the P positions of the task's forced prefix (the
  configuration's "prefix", event names that the reference codec
  encodes), which the program writes and does not choose; the reference
  is still teacher-forced on the whole row, prefix included.
- `prefix_mismatch` (only where P > 0): served rows whose first P ids are
  not the prefix.
- `note_mismatch`: notes that the program's detokenizer made from the
  window's ids and the reference detokenizer (a frozen copy of the Python
  walk, reference/tokens/) does not make from the same ids, or the other
  way round, times compared to the microsecond; plus every song whose
  MIDI notes are not the notes of one of its detokenizer calls.

With `control` (a reference.model.Numerics), the control's reading is
added: the widest gap of the token that the control puts first, at the
greedy positions, under the same prompts and tokens.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional

import numpy as np
import torch

from harness import inputs, weights
from reference import model as ref
from reference.tokens.codec import EventCodec
from reference.tokens.dataclasses import Event
from reference.tokens.event2note import merge_multi_channel_token_ids_to_notes

EOS_ID = 1


def to_host(song: dict) -> None:
    """Captured device tensors → numpy, once the window has closed."""
    for d in song["decodes"]:
        d["ids"] = d["ids"].cpu().numpy()
    for d in song["detok"]:
        if isinstance(d["ids"], torch.Tensor):
            d["ids"] = d["ids"].cpu().numpy()


def served(song: dict, n_segments: int):
    """→ ((S, C, L) greedy ids, {segment: (C, L) beam ids})."""
    greedy, beam = None, {}
    blocks = {p: [b for q, b in song["blocks"] if q == p] for p in (1, 2)}
    runs = {k: [d for d in song["decodes"] if d["kind"] == k] for k in ("greedy", "beam")}
    for block, d in zip(blocks[1], runs["greedy"]):
        if greedy is None:
            greedy = np.zeros((n_segments, *d["ids"].shape[1:]), np.int64)
        greedy[block] = d["ids"][: len(block)]
    for block, d in zip(blocks[2], runs["beam"]):
        for i, s in enumerate(block):
            beam[s] = d["ids"][i]
    if len(blocks[1]) != len(runs["greedy"]) or len(blocks[2]) != len(runs["beam"]):
        raise RuntimeError("decode calls do not match the segment blocks")
    return greedy, beam


def live(ids: torch.Tensor) -> torch.Tensor:
    """(…, L) ids → bool mask of the served positions: up to and with the
    first EOS."""
    eos = (ids == EOS_ID).to(torch.int32)
    before = torch.cumsum(eos, -1) - eos
    return before == 0


def codec(config: dict) -> EventCodec:
    d = config["detok"]
    return EventCodec(d["steps_per_second"], d["segment_seconds"],
                      d["num_velocity_bins"], tuple(d["extra_tokens"]))


def prefix_ids(config: dict) -> List[int]:
    """The task's forced prefix, encoded by the reference codec."""
    c = codec(config)
    return [c.encode_event(Event(name, 0)) for name in config["prefix"]]


def prefix_mismatch(prefix: List[int], greedy: np.ndarray, beam: dict) -> int:
    """Served rows (every channel of every greedy and beam segment) whose
    first len(prefix) ids are not the prefix."""
    rows = [greedy.reshape(-1, greedy.shape[-1])]
    rows += [b for _, b in sorted(beam.items())]
    head = np.concatenate(rows)[:, :len(prefix)]
    return int((head != np.asarray(prefix, head.dtype)).any(-1).sum())


def reference_detok(config: dict, ids: np.ndarray, starts: List[float]):
    S, C, _ = ids.shape
    notes, _ = merge_multi_channel_token_ids_to_notes(
        [[ids[s, c] for s in range(S)] for c in range(C)], list(starts), codec(config),
        default_programs=config["detok"]["default_programs"])
    return notes


def note_key(n):
    return (bool(n.is_drum), int(n.program), int(n.pitch), int(n.velocity),
            round(n.onset * 1e6), round(n.offset * 1e6))


def note_mismatch(config: dict, song: dict) -> int:
    bad = 0
    for call in song["detok"]:
        want = Counter(map(note_key, reference_detok(config, np.asarray(call["ids"]),
                                                     call["starts"])))
        got = Counter(map(note_key, call["notes"]))
        bad += sum(((want - got) + (got - want)).values())
    if not any(song["midi"] is c["notes"] for c in song["detok"]):
        bad += 1
    return bad


@torch.no_grad()
def gaps(config: dict, params: dict, audio: np.ndarray, greedy: np.ndarray,
         beam: dict, device, block: int, control: Optional[ref.Numerics] = None,
         forced: int = 0):
    """→ (widest served gap, widest control gap or None) over one song,
    past the `forced` positions of the prefix."""
    segs = inputs.segments(audio, config["audio"]["input_frames"])
    rows = [("greedy", s, greedy[s]) for s in range(len(segs))]
    rows += [("beam", s, ids) for s, ids in sorted(beam.items())]
    widest, widest_control = 0.0, None
    for i in range(0, len(rows), block):
        part = rows[i: i + block]
        x = torch.from_numpy(segs[[s for _, s, _ in part]]).to(device)
        ids = torch.from_numpy(np.stack([r for _, _, r in part])).to(device)
        lg = ref.logits(params, x, ids, config)
        top2 = torch.topk(lg, 2, dim=-1).values
        tok = torch.gather(lg, -1, ids[..., None])[..., 0]
        beam_row = torch.tensor([k == "beam" for k, _, _ in part], device=device)
        allowed = torch.where(beam_row[:, None, None], top2[..., 1], top2[..., 0])
        mask = live(ids) & (torch.arange(ids.shape[-1], device=device) >= forced)
        widest = max(widest, float(torch.clamp(allowed - tok, min=0)[mask].max()))
        if control is not None and not bool(beam_row.all()):
            g = ~beam_row
            lc = ref.logits(params, x[g], ids[g], config, num=control)
            pick = torch.gather(lg[g], -1, lc.argmax(-1)[..., None])[..., 0]
            gap_c = float((top2[g][..., 0] - pick)[mask[g]].max())
            widest_control = max(widest_control or 0.0, gap_c)
    return widest, widest_control


def check(config: dict, seed: int, songs: List[np.ndarray], captured: List[dict],
          device, traffic: dict, limits: dict, control=None) -> dict:
    acfg = config["audio"]
    ref.fp32_flags()
    params = weights.for_config(config, ref.param_shapes(config), seed, device)
    prefix = prefix_ids(config)
    gap, gap_c, notes, bad_prefix = 0.0, None, 0, 0
    for song in captured:
        audio = songs[song["song"]]
        greedy, beam = served(song, len(inputs.segments(audio, acfg["input_frames"])))
        g, c = gaps(config, params, audio, greedy, beam, device,
                    traffic["ref_segments_per_block"], control, len(prefix))
        gap = max(gap, g)
        if c is not None:
            gap_c = max(gap_c or 0.0, c)
        notes += note_mismatch(config, song)
        if prefix:
            bad_prefix += prefix_mismatch(prefix, greedy, beam)
    out = {"token_gap": {"value": gap, "limit": limits["token_gap"]},
           "note_mismatch": {"value": notes, "limit": limits["note_mismatch"]}}
    if prefix:
        out["prefix_mismatch"] = {"value": bad_prefix, "limit": limits["prefix_mismatch"]}
    if control is not None:
        out["control_token_gap"] = {"value": gap_c, "limit": limits["token_gap"]}
    return out
