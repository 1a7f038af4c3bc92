"""Tiny cells for the CPU: the benchmark's own cells with the widths and
depths cut to what a test can run, and short songs."""

from __future__ import annotations

import copy

from harness import core

TINY_MODEL = dict(d_model=64, d_kv=16, num_heads=4, d_ff=128,
                  num_encoder_layers=2, num_decoder_layers=2, ptf_d_latent=64,
                  ptf_num_blocks=1, conv_channels=8)


def tiny_cell(name: str, **traffic) -> core.Cell:
    cell = copy.deepcopy(core.find_cell(name))
    cell.config["model"].update(TINY_MODEL)
    if cell.traffic["kind"] == "transcribe":
        cell.traffic.update(songs=1, song_seconds=4.0, batch_size=2,
                            ref_segments_per_block=2)
    else:
        cell.traffic.update(batch_size=2, pool=4, ref_rows_per_block=1)
    cell.traffic.update(traffic)
    return cell
