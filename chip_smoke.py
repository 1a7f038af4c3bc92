#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (yourmt3_tpu_torch) on one GPU.

    python3 chip_smoke.py                # every phase (needs one CUDA card)
    python3 chip_smoke.py --kernels-only # phases 1-2: build and check kernels

Phases:
  1. device and build: the card's name and power limit, then every CUDA
     kernel of the three paths and the launch probe compiled from the
     sources in this checkout (one nvcc per source, all started together)
     and linked with the torch binding (ops/csrc/torch_ops.cpp) into one
     library of PyTorch operators, loaded with torch.ops.load_library;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of its path, in every mode; timed with CUDA events (over
     CUDA-graph replays for the decode kernels) beside its plain version,
     the one PyTorch call that computes the same function (library_ms)
     and its bound. The paged kernel is checked with the position on the
     host and in a tensor on the card (the two outputs equal bit for bit),
     and timed with the position on the card at pos 127, 511 and 1023 on
     its grid fixed by the cache length, at S = 8 and S = 48; the dense
     int8 kernel is checked at the flagship's self-attention shapes (S =
     104 and 208, L = 256, the step's bias row, the position on the host
     and on the card), at t5_small's cross shape (S = 8 and 16, T = 256)
     and with 2 and 3 query rows per head, and timed at both beside its
     byte bound, its plain version, SDPA on dequantized bf16 K/V and the
     paged kernel on int8 pages of the same rows; the fused
     log-mel kernel is held at B in
     {1, 8, 16}; the
     launch probe's own path is its launch-overhead measurement (eager
     through its operator in turns with torch's x + 1, then each inside
     one CUDA graph);
     then each wrapper's eager host µs per call beside torch's x + 1;
  3. the two main paths, each with every launch count set to 0 just
     before it and read just after:
     a. t5_small: the CLI transcribes a seeded ~6 s sine-mixture WAV at
        full width (random weights from a seed) through --decode-path
        fast with the beam-2 repair; the paged kernel's launches (self-
        attention) and the dense int8 kernel's (the int8 cross K/V) must
        each equal 8 (decoder layers) x the decode steps run;
     b. the flagship perceiver_tf_mc13 (kv_quant="int8c4p", int8 decoder
        weights): api.init_model + api.transcribe on a seeded 16 s song
        (8 segments, one batch, 104 decoder streams) with the beam-2
        repair; the int4 cross kernel's and the dense int8 kernel's
        launches must each equal 8 x the decode steps run, and the paged
        kernel must not launch;
  4. each kernel inside its model: 64 bf16 decode steps through the kernel
     against the plain path on the same tokens, and a small fp32 model on
     the card against the same model on the CPU;
  5. where the time goes, for each path: its stages on the host clock,
     and a window of its decode steps under torch.profiler (device busy
     time, idle share, the kernels that take the time);
  6. training, slice 3: the full-width flagship with the fused log-mel
     frontend (use_pallas=True), batch 16, about 20 steps of
     trainer.train on one repeated batch of a synth set built by the
     port's own builder; the kernel must launch once per step and the
     loss must fall. Then a profiled window of 3 steps, a checkpoint
     restored with load_checkpoint(kv_quant="int8c4p",
     weight_quant="int8") that transcribes a 2 s song, and two steps of
     cli.train at t5_small width whose batches two spawned producer
     processes make (--num-workers 2);
  7. evaluation, slice 4, on phase 6's checkpoint in the same directory:
     a. a test split of synth_mc (2 tracks of 8 s, another seed) built by
        the port's build_synth_dataset;
     b-d. python -m yourmt3_tpu_torch.cli.test on it with int8c4p K/V and
        int8 weights, batch 8: per-track lines, the wall and audio-s/s; the
        JSON must hold the evaluator's keys and the int4 kernel's launches
        must equal 8 x the decode steps run;
     e. api.transcribe_audio_array on a training song with and without
        early_exit (repair off), then (the checkpoint ends every stream at
        once) greedy_decode_early_exit against greedy_decode on phase 3b's
        full-width flagship (int4 kernel, 104 streams) and on t5_small's
        fast path (paged kernel, 48 streams, L 512), each stopping at a
        token its plain decode emits at different steps: at least one
        compaction each, and the tokens equal or parting only where the
        plain decode's top two logits lie within MARGIN_ULPS bf16 ulps;
     f. batch invariance: the paged kernel (48 streams, int8 pages, pos
        511 and 1023) and the int4 kernel (104 streams) on the kept rows of
        a compacted batch (8 and 16 streams) must equal the full batch's
        bit for bit (the paged kernel's split depends on the cache length
        alone).
  8. the MoE flagship and the conformer, slice 5, each path with every
     launch count set to 0 just before it and read just after:
     a. perceiver_tf_mc13_moe (8 experts, top-2, in every Perceiver-TF
        block) at full width with kv_quant="int8c4p" and int8 decoder
        weights: api.init_model + api.transcribe on phase 3b's seeded 16 s
        song (batch 8, 104 streams, the beam-2 repair); the int4 kernel's
        launches must equal 8 x the decode steps run and the paged kernel
        must not launch; then the encoder of one batch under
        torch.profiler: its device ms and the MoE FFs' share of them, and
        a profiled window of 32 decode steps (as in phase 5);
     b. conformer_small: the CLI transcribes phase 3a's 6 s WAV through
        --decode-path fast (L = 1024: the int8 paged kernel) with the
        beam-2 repair; the paged kernel's launches must equal 8 x the
        decode steps run; then its encoder's device ms on a batch of 8
        and a profiled window of 32 decode steps;
     c. every other encoder option at full width in fp32, the card against
        the CPU on one seeded batch of 2 segments, same weights: the
        flagship with ptf_pos_enc "rope" and "alibi" and with proj_type
        "group-conv"; conformer_small with proj_type "mlp",
        "depthwise-conv" and "linear-forced"; t5_small with ff_act "moe".
        The encoder output must agree within TOL_MODEL_FP32 and the
        decoder memory (bf16 after a projection layer) within
        MEMORY_ULPS bf16 ulps.
  9. data-parallel training and chunk-parallel evaluation, slice 6, each
     path with every launch count set to 0 just before it and read just
     after:
     c. in an NCCL group of world 1: cli.test scores phase 7's split
        chunk-parallel (8 segments per rank, then 2); the int4 kernel's
        launches must equal 8 x the decode steps run and the metrics JSON
        must be phase 7's; then transcribe_song_chunk_parallel decodes phase
        3a's song on t5_small's fast path (paged kernel, 8 x the steps) and
        must give the one-device path's notes and errors; then at unequal
        shapes (2 segments per rank against the one-device batch of 8) the
        same song, and an 8 s song on the random-weight flagship (int4
        kernel): streams may part only where the one-device decode's top two
        logits lie within MARGIN_ULPS bf16 ulps;
     a. in the same group: the full-width flagship through
        trainer.train(n_data_shards=1) under DDP, batch 16, fused log-mel
        frontend, 5 steps of phase 6's run (the kernel launches once per
        step), against the same steps without a group: the losses must
        agree within TOL_DDP1_LOSS_REL; steps/s and peak memory beside
        phase 6's;
     b. two gloo ranks on the one card (spawned processes) train t5_small
        in fp32 with dropout 0.1 and SpecAugment on halves of global batches
        of 8 for 2 steps; the losses and weights must equal one process's
        (the same masks: each rank keeps its rows of the global batch's)
        within TOL_DDP2_LOSS_REL and TOL_DDP2_WEIGHT_REL.
 10. tensor parallel over the model axis and reference checkpoints, slice 7,
     each path with every launch count set to 0 just before it (in each
     rank) and read just after:
     a. the full-width flagship in fp32 (fused log-mel frontend, dropout
        0.05, SpecAugment) on a mesh of (data=1, model=2): two gloo ranks
        share the card, parameters placed by mesh.shard_params, 3 AdamW
        steps on a global batch of 8, against one process on the same
        batch and generator seed: losses within TOL_TP_LOSS_REL, weights
        within the TOL_TP_* rules; steps/s of both, peak memory per rank,
        fused log-mel launches = steps in each rank;
     b. the full-width MoE flagship, experts sharded, on (data=2, model=2):
        four ranks, 2 steps, dropout 0.05 and SpecAugment, held the same way;
     c. 10a's checkpoint (written whole by the sharded ranks) restores in
        one process with the gathered weights and transcribes phase 3b's
        16 s song through api.transcribe and the int4 kernel;
     d. a reference-style .ckpt of a seeded full-width MoE flagship (experts
        unstacked) loads through import_checkpoint(require_complete=True)
        into a model of another seed, whose logits must equal the source's.
 11. the grouped-query flagships perceiver_tf_mc13_mqa and
     perceiver_tf_mc13_gqa2 (decoder_kv_heads 1 and 2), slice 8, each with
     every launch count set to 0 just before it and read just after (their
     caches are dense, as the JAX package's: only the dense int8 kernel
     launches, 2 x 8 a step, self and cross, each for the 6 or 3 query heads
     of a KV head): at
     full width in fp32, random weights from seed 0, 2 segments of the 16 s
     song (L = 256) through transcribe_segments_array with the fast decode
     settings of a 13-channel decode (dense int8 self cache) and the beam-2
     repair: wall, audio-s/s and peak memory; encoder and memory against
     the CPU within phase 8c's limits; the card's memory decoded on the
     CPU, the card's greedy tokens parting from it only where the CPU's
     top two logits lie within MARGIN_ULPS bf16 ulps; then 64 steps of the
     caches none, int8c4 and int4 and of beam 2 on the card.

Any failure raises: nothing is caught and nothing falls back. The last
line is {"ok": true, "device": {...}}; the line before it lists each
kernel's launches, error and times.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores

H, DK, BLOCK, NB, BUCKETS, MAXD = 6, 64, 128, 8, 32, 128
L = NB * BLOCK
POSITIONS = (0, 127, 128, 511, 1023)
# kernel vs plain version, both accumulating in fp32 in another order
TOL_FP32 = 1e-4
# bf16 outputs: both round the same fp32 value; a value next to a rounding
# boundary may round one bf16 ulp apart (2^-6 for |x| in [2, 4))
TOL_BF16 = 1.6e-2
# bf16 t5_small logits, paged kernel vs dense path: the dense path rounds
# the softmax weights to bf16 before the V product, the kernel keeps them
# fp32, and one-ulp differences in the bf16 residual stream pass through
# 8 layers; 0.25 is 8 ulps of the largest logits (|x| < 8: ulp 2^-5)
TOL_MODEL_BF16 = 0.25
# fp32 model on the card vs on the CPU (TF32 off): summation order only
TOL_MODEL_FP32 = 1e-3
# the same with an int8 self cache quantized on each device: a one-ulp
# difference in a projection can move a K/V value by one int8 level
# (scale/127 of its row), as in tests/test_torch_t5.py
TOL_MODEL_INT8 = 2e-2
# int4 cross kernel's shape on the flagship path: H, dk, T (encoder frames)
H4, DK4, T4 = 6, 64, 256
FLAGSHIP = dict(kv_quant="int8c4p", weight_quant="int8")
# the tiny flagship of tests/test_torch_flagship.py
TINY_FLAGSHIP = dict(d_model=64, d_kv=16, num_heads=4, d_ff=128,
                     num_decoder_layers=2, ptf_d_latent=64, ptf_num_blocks=1,
                     conv_channels=8)
# fused log-mel kernel vs plain version (both fp32, sums in another
# order; inputs carry a noise floor, so no mel bin sits at the log offset)
TOL_LOGMEL = 1e-3
LOGMEL_BATCHES = (1, 8, 16)
TRAIN_BATCH, TRAIN_STEPS, PROFILED_STEPS = 16, 20, 3
PROBE_ROUNDS = 7  # chains of the probe and of torch's x + 1, in turns
# programs of the synthetic multi-instrument set (preset synth_mc)
SYNTH_MC_PROGRAMS = (0, 24, 32, 40, 56, 73)
# keys the evaluator writes on a set whose tracks hold pitched notes and
# drums, scored with an eval program vocabulary (eval/evaluator.py)
EVAL_KEYS = ("onset_f1", "offset_f1", "multi_f1", "drum_f1", "onset_precision",
             "onset_recall", "multi_precision", "multi_recall",
             "decode_errors", "num_tracks", "per_class")
OFFSET_KEYS = ("n_pairs", "mean_signed_s", "median_signed_s", "std_s",
               "p_early", "p_late", "p_within_tol")
# phase 8c: bf16 decoder memory on the card against the CPU, in bf16 ulps
# taken at magnitude 1 or more: fp32 encoder outputs ~1e-5 apart round to
# bf16 one ulp apart now and then, and the mlp projection's second layer
# can carry such a difference into one more ulp
MEMORY_ULPS = 2
# phase 8c: each option as (preset, task, overrides)
OPTIONS = (
    ("perceiver_tf_mc13", "mc13_full_plus_256", {"ptf_pos_enc": "rope"}),
    ("perceiver_tf_mc13", "mc13_full_plus_256", {"ptf_pos_enc": "alibi"}),
    ("perceiver_tf_mc13", "mc13_full_plus_256", {"proj_type": "group-conv"}),
    ("conformer_small", "mt3_full_plus", {"proj_type": "mlp"}),
    ("conformer_small", "mt3_full_plus", {"proj_type": "depthwise-conv"}),
    ("conformer_small", "mt3_full_plus", {"proj_type": "linear-forced"}),
    ("t5_small", "mt3_full_plus", {"ff_act": "moe"}),
)
# early exit against plain greedy on the card: a stream may part only
# where the plain decode's top two logits lie within this many bf16 ulps
# of the top logit (a batch of another size may round another way)
MARGIN_ULPS = 4


def log(msg: str) -> None:
    print(msg, flush=True)


def graph_ms(fn, calls_per_fn: int, replays: int = 10) -> float:
    """Device ms per call: `fn` captured once as a CUDA graph, replayed."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls_per_fn)


# ---------------------------------------------------------------------------
# phase 2: kernel against its plain version
# ---------------------------------------------------------------------------

def make_pages(S, quantized, gen, dev, nb=NB):
    import torch
    from yourmt3_tpu_torch.ops.kv_quant import quantize_kv
    out = {}
    for n in "kv":
        x = torch.randn(nb, S, H, BLOCK, DK, generator=gen)
        if quantized:
            vals, sc = quantize_kv(x)  # (NB, S, H, block) scales
            out[n] = vals.to(dev)
            out[n + "s"] = sc.permute(1, 0, 2, 3).contiguous().to(dev)
        else:
            out[n] = x.to(torch.bfloat16).to(dev)
    return out


def check_kernel(dev):
    import torch
    from yourmt3_tpu_torch.ops import decode_attention as da
    gen = torch.Generator().manual_seed(0)
    table = (torch.randn(BUCKETS, H, generator=gen) * 0.5).to(dev)
    dist = da.distance_buckets(BUCKETS, MAXD).to(dev)
    worst = {"fp32": 0.0, "bf16": 0.0}
    for S in (8, 16):
        q = torch.randn(S, H, DK, generator=gen).to(dev)
        row = torch.randn(H, L, generator=gen).to(dev)
        int8 = make_pages(S, True, gen, dev)
        bf16 = make_pages(S, False, gen, dev)
        cross = make_pages(S, False, gen, dev, nb=2)  # T = 256
        modes = [
            ("int8+table", int8, dict(rel_table=table, dist_buckets=dist,
                                      k_scale=int8["ks"], v_scale=int8["vs"]),
             POSITIONS),
            ("bf16+table", bf16, dict(rel_table=table, dist_buckets=dist),
             POSITIONS),
            ("bf16+row", bf16, dict(bias_row=row), POSITIONS),
            ("cross", cross, {}, (255,)),
        ]
        for name, pages, kw, positions in modes:
            errs = {"fp32": 0.0, "bf16": 0.0}
            for pos in positions:
                for qt, qdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                    qq = q.to(qdt)
                    plain_kw = {k: v for k, v in kw.items() if k != "dist_buckets"}
                    want = da.paged_decode_attention_plain(
                        qq, pages["k"], pages["v"], pos, **plain_kw)
                    # the host position, then the position in a tensor on the
                    # card, read by the kernel, as a graphed decode step gives it
                    host = da.paged_decode_attention(qq, pages["k"], pages["v"],
                                                     pos, **kw)
                    on_card = da.paged_decode_attention(
                        qq, pages["k"], pages["v"], torch.tensor(pos, device=dev), **kw)
                    for got in (host, on_card):
                        assert got.dtype == qdt and got.shape == (S, H, DK)
                        assert bool(torch.isfinite(got).all())
                        err = (got.float() - want.float()).abs().max().item()
                        errs[qt] = max(errs[qt], err)
                    assert torch.equal(on_card, host), (S, name, pos, qt)
            torch.cuda.synchronize()
            log(f"kernel check S={S} {name:10s} pos={list(positions)} on the host and "
                f"on the card (equal): max|err| fp32 q {errs['fp32']:.3e} (tol "
                f"{TOL_FP32}), bf16 q {errs['bf16']:.3e} (tol {TOL_BF16})")
            assert errs["fp32"] < TOL_FP32, (S, name, errs)
            assert errs["bf16"] < TOL_BF16, (S, name, errs)
            for k in worst:
                worst[k] = max(worst[k], errs[k])
    return worst


def bound(S, pos):
    """(ms, "bytes" or "operations"): least time for one call at the main
    path's shape (int8 pages, table bias), each input byte read once and
    the output written once."""
    rows = pos + 1
    nbytes = (S * H * DK * 2  # q bf16
              + 2 * S * H * rows * DK  # live int8 K and V rows
              + 2 * S * H * rows * 4  # their fp32 scales
              + BUCKETS * H * 4 + (MAXD + 1) * 4  # table, distance buckets
              + S * H * DK * 2)  # out bf16
    ops = 4 * S * H * rows * DK  # q.k and p.v multiply-adds
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_kernel(dev, batches=(8, 48)):
    """Times at the main path's shape: int8 pages, table bias, a decoder's
    8 layer caches cycled (53 MB at S = 8, about the size of L2), at S = 8
    (t5_small's batch) and S = 48 (phase 7e's), the kernel on its grid
    fixed by the cache length with the position in a tensor on the card,
    as a graphed decode step gives it. → {(S, pos): row}."""
    import torch
    import torch.nn.functional as F
    from yourmt3_tpu_torch.models.layers import relative_position_bucket
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops.kv_quant import dequantize_kv
    gen = torch.Generator().manual_seed(1)
    layers = 8
    table = (torch.randn(BUCKETS, H, generator=gen) * 0.5).to(dev)
    dist = da.distance_buckets(BUCKETS, MAXD).to(dev)
    rows = {}
    for S in batches:
        q = torch.randn(S, H, DK, generator=gen).to(dev).to(torch.bfloat16)
        caches = [make_pages(S, True, gen, dev) for _ in range(layers)]

        def dense(c, n):  # (NB,S,H,block,dk) int8 + (S,NB,H,block) → (S,H,L,dk)
            vals = c[n].permute(1, 2, 0, 3, 4).reshape(S, H, L, DK)
            sc = c[n + "s"].permute(0, 2, 1, 3).reshape(S, H, L)
            return dequantize_kv(vals, sc).to(torch.bfloat16)

        dense_kv = [(dense(c, "k"), dense(c, "v")) for c in caches]
        for pos in (127, 511, 1023):
            kw = dict(rel_table=table, dist_buckets=dist)
            on_card = torch.tensor(pos, device=dev)
            j = torch.arange(L, device=dev, dtype=torch.int32)
            bias = table[relative_position_bucket(j - pos, False, BUCKETS, MAXD).long()].T
            mask = torch.where(j <= pos, bias, torch.full_like(bias, float("-inf")))
            mask = mask[None, :, None, :].to(torch.bfloat16)  # (1, H, 1, L)
            q4 = q[:, :, None, :]

            def kernel():
                for c in caches:
                    da.paged_decode_attention(q, c["k"], c["v"], on_card,
                                              k_scale=c["ks"], v_scale=c["vs"], **kw)

            def plain():
                for c in caches:
                    da.paged_decode_attention_plain(q, c["k"], c["v"], pos,
                                                    rel_table=table, k_scale=c["ks"],
                                                    v_scale=c["vs"])

            def library():
                for kd, vd in dense_kv:
                    F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask,
                                                   scale=1.0)

            b_ms, b_by = bound(S, pos)
            splits, split_rows = da.decode_splits(L)
            r = rows[S, pos] = dict(
                ms=graph_ms(kernel, layers), plain_ms=graph_ms(plain, layers),
                library_ms=graph_ms(library, layers), bound_ms=b_ms, bound_by=b_by)
            log(f"time S={S} int8+table pos={pos} on the card ({splits} ranges of "
                f"{split_rows} rows, {S * H * splits} CTAs): kernel {r['ms'] * 1e3:.2f} us, plain "
                f"{r['plain_ms'] * 1e3:.2f} us, library (SDPA, dense bf16) "
                f"{r['library_ms'] * 1e3:.2f} us, bound ({b_by}) {b_ms * 1e3:.2f} us")
        del caches, dense_kv
    return rows


def int4_inputs(S, gen, dev, dk=DK4, T=T4):
    """Packed int4 cross K/V of N(0, 1) rows: [k4, ks, v4, vs] on dev."""
    import torch
    from yourmt3_tpu_torch.ops.kv_quant import quantize_kv4_crosspack
    out = []
    for _ in "kv":
        packed, scale = quantize_kv4_crosspack(torch.randn(S, H4, T, dk, generator=gen))
        out += [packed.to(dev), scale.to(dev)]
    return out


def check_int4(dev):
    """The int4 cross kernel against its plain version at S in {8, 104},
    T in {128, 256}, dk in {32, 64}, fp32 and bf16 q."""
    import torch
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia
    gen = torch.Generator().manual_seed(2)
    worst = {"fp32": 0.0, "bf16": 0.0}
    for S in (8, 104):
        for T in (128, 256):
            for dk in (32, 64):
                kv = int4_inputs(S, gen, dev, dk, T)
                q = torch.randn(S, H4, dk, generator=gen).to(dev)
                errs = {}
                for qt, qdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                    qq = q.to(qdt)
                    got = ia.int4_cross_attention(qq, *kv)
                    want = ia.int4_cross_attention_plain(qq, *kv)
                    assert got.dtype == qdt and got.shape == (S, H4, dk)
                    assert bool(torch.isfinite(got).all())
                    errs[qt] = (got.float() - want.float()).abs().max().item()
                    worst[qt] = max(worst[qt], errs[qt])
                torch.cuda.synchronize()
                log(f"int4 kernel check S={S} T={T} dk={dk}: max|err| fp32 q "
                    f"{errs['fp32']:.3e} (tol {TOL_FP32}), bf16 q "
                    f"{errs['bf16']:.3e} (tol {TOL_BF16})")
                assert errs["fp32"] < TOL_FP32, (S, T, dk, errs)
                assert errs["bf16"] < TOL_BF16, (S, T, dk, errs)
    return worst


def bound_int4(S):
    """(ms, "bytes" or "operations") for one int4 cross call at the
    flagship's shape: bf16 q and out, packed K and V, fp32 scales, each
    read or written once."""
    nbytes = (2 * S * H4 * DK4 * 2  # q and out, bf16
              + 2 * S * H4 * (DK4 // 2) * T4  # packed K and V
              + 2 * S * H4 * T4 * 4)  # their fp32 scales
    ops = 4 * S * H4 * T4 * DK4  # q.k and w.v multiply-adds
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_int4(dev):
    """Times at S = 104 (8 segments x 13 channels, the flagship's batch)
    and S = 624 (the tuned batch of 48), bf16 q, the 8 decoder layers'
    cross caches cycled."""
    import torch
    import torch.nn.functional as F
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia
    from yourmt3_tpu_torch.ops.kv_quant import dequantize_kv4_crosspack
    gen = torch.Generator().manual_seed(3)
    layers, rows = 8, {}
    for S in (104, 624):
        q = torch.randn(S, H4, DK4, generator=gen).to(dev).to(torch.bfloat16)
        caches = [int4_inputs(S, gen, dev) for _ in range(layers)]
        dense = [(dequantize_kv4_crosspack(k4, ks).to(torch.bfloat16),
                  dequantize_kv4_crosspack(v4, vs).to(torch.bfloat16))
                 for k4, ks, v4, vs in caches]
        q4 = q[:, :, None, :]

        def kernel():
            for c in caches:
                ia.int4_cross_attention(q, *c)

        def plain():
            for c in caches:
                ia.int4_cross_attention_plain(q, *c)

        def library():
            for kd, vd in dense:
                F.scaled_dot_product_attention(q4, kd, vd, scale=1.0)

        b_ms, b_by = bound_int4(S)
        rows[S] = dict(ms=graph_ms(kernel, layers), plain_ms=graph_ms(plain, layers),
                       library_ms=graph_ms(library, layers),
                       bound_ms=b_ms, bound_by=b_by)
        r = rows[S]
        log(f"time int4 cross S={S} H={H4} dk={DK4} T={T4}: kernel "
            f"{r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} us, "
            f"library (SDPA, dense bf16) {r['library_ms'] * 1e3:.2f} us, bound "
            f"({b_by}) {b_ms * 1e3:.2f} us")
        del caches, dense
    return rows


# the dense int8 kernel's shapes: the flagship's self-attention (H, dk, L)
# at its greedy and beam stream counts, and t5_small's cross-attention
H8, DK8, L8 = 6, 64, 256
FLAGSHIP_STREAMS = (104, 208)
T5_CROSS_STREAMS = (8, 16)


def int8_case(S, M, n, pos, gen, dev, bias=True, heads=H8, dk=DK8):
    """Whole int8 caches (S, heads, n, dk) of N(0, 1) rows with fp32 row
    scales, q (S, heads, M, dk) fp32 and, with `bias`, a step bias row
    (1, heads, M, n) as `kv_cache.step_bias` builds it: a gathered,
    transposed relative bias (not contiguous), -1e9 past pos."""
    import torch
    from yourmt3_tpu_torch.ops.kv_quant import quantize_kv
    kq, ks = quantize_kv(torch.randn(S, heads, n, dk, generator=gen))
    vq, vs = quantize_kv(torch.randn(S, heads, n, dk, generator=gen))
    q = torch.randn(S, heads, M, dk, generator=gen)
    b = None
    if bias:
        rel = (torch.randn(n, heads * M, generator=gen) * 0.5).T.reshape(1, heads, M, n)
        b = (rel + torch.where(torch.arange(n) > pos, -1e9, 0.0)).to(dev)
    return [t.to(dev) for t in (q, kq, ks, vq, vs)] + [b]


def int8_tols(vq, vs, want, bf16_out):
    """(max, mean) tolerances of the int8 kernel against its plain version:
    both round each softmax weight w·vs to bf16 after summing exponentials
    in another order, so a weight may round one bf16 ulp (2^-7) apart, and
    the weights sum to one: 2^-7 max |v·vs|, plus one ulp of a bf16 output;
    the mean stays at the fp32 summation order's."""
    vmax = (vq.float() * vs[..., None]).abs().max().item()
    ulp = 2.0 ** -7 * want.float().abs().max().item() if bf16_out else 0.0
    return 2.0 ** -7 * vmax + ulp + 1e-5, 1e-3 if bf16_out else 1e-5


def check_int8(dev):
    """The dense int8 kernel against its plain version: the flagship's
    self-attention (S = 104, 208; pos 0, 127, 255, on the host and on the
    card, bit-identical), t5_small's cross-attention (S = 8, 16; no bias or
    position), 2 and 3 query rows per head; fp32 and bf16 q."""
    import torch
    from yourmt3_tpu_torch.ops import kv_quant as kq
    gen = torch.Generator().manual_seed(9)
    worst = {"fp32": 0.0, "bf16": 0.0}
    cases = ([(f"self S={S}", S, 1, 6, pos, True) for S in FLAGSHIP_STREAMS
              for pos in (0, 127, 255)]
             + [(f"cross S={S}", S, 1, 6, None, False) for S in T5_CROSS_STREAMS]
             + [("grouped M=2", 8, 2, 3, 200, True), ("grouped M=3", 8, 3, 2, 255, True)])
    for name, S, M, heads, pos, bias in cases:
        q, k, ks, v, vs, b = int8_case(S, M, L8, 255 if pos is None else pos, gen, dev,
                                       bias, heads)
        errs = {}
        for qt, qdt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            qq = q.to(qdt)
            got = kq.int8_decode_attention(qq, k, ks, v, vs, b, pos=pos)
            want = kq.int8_decode_attention_plain(qq, k, ks, v, vs, b)
            if pos is not None:
                on_card = kq.int8_decode_attention(qq, k, ks, v, vs, b,
                                                   pos=torch.tensor(pos, device=dev))
                assert torch.equal(on_card, got), (name, pos, qt)
            assert got.dtype == qdt and got.shape == (S, heads, M, DK8)
            err = (got.float() - want.float()).abs()
            top, mean = int8_tols(v, vs, want, qt == "bf16")
            errs[qt] = err.max().item()
            assert errs[qt] < top and err.mean().item() < mean, (name, pos, qt, errs, top)
            worst[qt] = max(worst[qt], errs[qt])
        torch.cuda.synchronize()
        log(f"int8 kernel check {name} pos={pos} (host and card positions equal): "
            f"max|err| fp32 q {errs['fp32']:.3e}, bf16 q {errs['bf16']:.3e} (tol: one "
            f"bf16 ulp of every weight, {top:.3e})")
    return worst


def bound_int8(S, live, dk=DK8):
    """(ms, "bytes" or "operations") of one call reading `live` rows: bf16 q
    and out, int8 K and V and their fp32 scales, each moved once (the
    benchmark's counts/flops.paged_decode_call)."""
    nbytes = 2 * S * H8 * dk * 2 + 2 * S * H8 * live * (dk + 4)
    ops = 4 * S * H8 * live * dk
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_int8(dev):
    """Times over CUDA-graph replays, the 8 decoder layers' caches cycled:
    the flagship's self-attention (S = 104, 208; pos 0, 127, 255 in a
    tensor on the card, as the graphed step gives it) beside the plain
    version over the whole cache (the route this kernel replaced), SDPA on
    dequantized bf16 K/V with the bias as its mask, and the paged kernel on
    int8 pages of 64 rows holding the same values; t5_small's
    cross-attention (S = 8, 16, T = 256) beside the plain version and SDPA.
    → {(kind, S, pos): row}."""
    import torch
    import torch.nn.functional as F
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops import kv_quant as kq
    from yourmt3_tpu_torch.ops.kv_quant import dequantize_kv
    gen = torch.Generator().manual_seed(10)
    layers, rows, block = 8, {}, 64
    table = (torch.randn(BUCKETS, H8, generator=gen) * 0.5).to(dev)
    dist = da.distance_buckets(BUCKETS, MAXD).to(dev)

    def paged(t):  # (S, H, L, dk) → (NB, S, H, block, dk); (S, H, L) → (S, NB, H, block)
        if t.ndim == 4:
            S = t.shape[0]
            return t.reshape(S, H8, L8 // block, block, -1).permute(2, 0, 1, 3, 4).contiguous()
        return t.reshape(t.shape[0], H8, L8 // block, block).permute(0, 2, 1, 3).contiguous()

    for kind, streams in (("self", FLAGSHIP_STREAMS), ("cross", T5_CROSS_STREAMS)):
        for S in streams:
            caches = [int8_case(S, 1, L8, L8 - 1, gen, dev, bias=False)[1:5]
                      for _ in range(layers)]
            q = torch.randn(S, H8, 1, DK8, generator=gen).to(dev).to(torch.bfloat16)
            dense = [(dequantize_kv(k, ks).to(torch.bfloat16),
                      dequantize_kv(v, vs).to(torch.bfloat16)) for k, ks, v, vs in caches]
            pages = [[paged(t) for t in c] for c in caches] if kind == "self" else None
            for pos in ((0, 127, 255) if kind == "self" else (None,)):
                b = on_card = mask = None
                live = L8
                if pos is not None:
                    live = pos + 1
                    b = int8_case(1, 1, L8, pos, gen, dev, bias=True)[-1]
                    on_card = torch.tensor(pos, device=dev)
                    mask = b.masked_fill(b < -1e8, float("-inf")).to(torch.bfloat16)

                def kernel():
                    for c in caches:
                        kq.int8_decode_attention(q, *c, b, pos=on_card)

                def plain():
                    for c in caches:
                        kq.int8_decode_attention_plain(q, *c, b)

                def library():
                    for kd, vd in dense:
                        F.scaled_dot_product_attention(q, kd, vd, attn_mask=mask, scale=1.0)

                def paged_kernel():
                    for k, ks, v, vs in pages:
                        da.paged_decode_attention(q, k, v, on_card, rel_table=table,
                                                  dist_buckets=dist, k_scale=ks, v_scale=vs)

                b_ms, b_by = bound_int8(S, live)
                r = rows[kind, S, pos] = dict(
                    ms=graph_ms(kernel, layers), plain_ms=graph_ms(plain, layers),
                    library_ms=graph_ms(library, layers), bound_ms=b_ms, bound_by=b_by,
                    paged_ms=graph_ms(paged_kernel, layers) if pages else None)
                paged_msg = (f", paged kernel on int8 pages {r['paged_ms'] * 1e3:.2f} us"
                             if pages else "")
                log(f"time int8 {kind} S={S} H={H8} dk={DK8} L={L8} pos={pos} ({S * H8} "
                    f"CTAs): kernel {r['ms'] * 1e3:.2f} us, plain {r['plain_ms'] * 1e3:.2f} "
                    f"us, library (SDPA, dense bf16) {r['library_ms'] * 1e3:.2f} us"
                    f"{paged_msg}, bound ({b_by}) {b_ms * 1e3:.2f} us = "
                    f"{100 * b_ms / r['ms']:.1f} % of the kernel's time")
            del caches, dense, pages
    return rows


def events_ms(fn, iters: int) -> float:
    """Device ms per call: `fn` issued eagerly `iters` times between two
    CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def logmel_audio(B, dev):
    """(B, 32767) segments of a seeded sine mixture over a noise floor."""
    import torch
    from yourmt3_tpu_torch.config.audio import DEFAULT_AUDIO
    from yourmt3_tpu_torch.data.audio_io import slice_padded_array
    segs, _ = slice_padded_array(sine_song(2.048 * B + 1.0, seed=B),
                                 DEFAULT_AUDIO.input_frames)
    return torch.from_numpy(np.ascontiguousarray(segs[:B])).to(dev)


def logmel_frontend(dev):
    from yourmt3_tpu_torch.config.audio import DEFAULT_AUDIO
    from yourmt3_tpu_torch.ops.frontend import SpectrogramFrontend
    return SpectrogramFrontend.from_config(DEFAULT_AUDIO, use_pallas=True,
                                           device=dev)


def check_logmel(dev):
    """The fused log-mel kernel against its plain version (the two-level
    DFT) at full width (32767 samples → 256 frames × 512 mels), B in
    {1, 8, 16}; beside it the FFT algorithm's plain version, and each
    route's max and RMS error to the function in float64."""
    import torch
    from yourmt3_tpu_torch.ops import fused_logmel as fl
    fe = logmel_frontend(dev)
    bases = (fe.basis_cos, fe.basis_sin, fe.mel_fb, fe.cfg)
    packed = fl.pack_bases(*bases[:3])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    worst = 0.0
    for B in LOGMEL_BATCHES:
        audio = logmel_audio(B, dev)
        got = fe(audio)
        want = fl.fused_logmel_plain(audio, *bases)
        fft = fl.fused_logmel_fft_plain(audio, *bases, packed=packed)
        ref = fl.fused_logmel_float64(audio, fe.basis_cos, fe.mel_fb, fe.cfg)
        torch.cuda.synchronize()
        assert got.shape == (B, 256, 512) and bool(torch.isfinite(got).all())
        err = (got - want).abs().max().item()
        err_fft = (got - fft).abs().max().item()
        to64 = {name: ((x.double() - ref).abs().max().item(),
                       (x.double() - ref).pow(2).mean().sqrt().item())
                for name, x in (("kernel", got), ("DFT plain", want))}
        log(f"fused_logmel check B={B} (frames per CTA "
            f"{fl.frames_per_cta(B, 256, sms)}): max|err| {err:.3e} (tol "
            f"{TOL_LOGMEL}); to the FFT's plain version {err_fft:.3e}; to "
            f"float64 (max, RMS): " + ", ".join(
                f"{name} {mx:.3e}, {rms:.3e}" for name, (mx, rms) in to64.items()))
        assert err <= TOL_LOGMEL, (B, err)
        assert err_fft <= TOL_LOGMEL, (B, err_fft)
        worst = max(worst, err)
    return worst


def bound_logmel(B, cfg, packed):
    """(ms, "bytes" or "operations"): the function's least time. Bytes:
    the audio, the packed constants (window, twiddles, mel bands and
    weights) and the output each moved once. Operations (fp32): the
    frames' FFTs, two frames to one complex n_fft-point transform of
    5·N·log2 N; the split and magnitudes, 12 per bin and frame; the band
    weights, a multiply-add each; one log per output."""
    n_fft, T, M = cfg.n_fft, cfg.num_frames, cfg.n_mels
    n_bins = n_fft // 2 + 1
    nnz = packed[3].numel()
    ops = B * (-(-T // 2) * 5 * n_fft * int(np.log2(n_fft))
               + T * (12 * n_bins + 2 * nnz + M))
    nbytes = (4 * (B * cfg.input_frames + B * T * M)
              + sum(t.numel() * t.element_size() for t in packed))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bound_logmel_dft(B, cfg):
    """The TPU kernel's algorithm's bound, for comparison: its DFT (cos and
    sin) and dense mel products' fp32 multiply-adds, ms."""
    n_bins, T = cfg.n_fft // 2 + 1, cfg.num_frames
    ops = B * (2 * 2 * T * cfg.n_fft * n_bins + 2 * T * n_bins * cfg.n_mels)
    return ops / FP32_FLOPS * 1e3


def time_logmel(dev):
    """Kernel, plain version and the cuFFT route (torch.stft with a
    periodic Hann window, center=True, reflect; abs; mel product; log:
    four calls, not one) at B = 16 (training) and 8 (serving). The
    kernel's time is the operator (reflect pad and kernel) over CUDA-graph
    replays, so the wrapper's host time per call does not hide it; beside
    it the same over 10 eager calls between CUDA events,
    as the plain version and the cuFFT route are timed. Then the kernel
    at each tile of frames per CTA, the wrapper's choice marked."""
    import torch
    from yourmt3_tpu_torch.ops import cuda_build
    from yourmt3_tpu_torch.ops import fused_logmel as fl
    fe = logmel_frontend(dev)
    cfg = fe.cfg
    packed = fl.pack_bases(fe.basis_cos, fe.basis_sin, fe.mel_fb)
    op = cuda_build.op("fused_logmel")
    win = torch.hann_window(cfg.n_fft, periodic=True, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = {}
    for B in (16, 8):
        audio = logmel_audio(B, dev)
        args = (audio, fe.basis_cos, fe.basis_sin, fe.mel_fb, cfg)

        def library():
            spec = torch.stft(audio, cfg.n_fft, hop_length=cfg.hop_length,
                              window=win, center=True, pad_mode="reflect",
                              return_complex=True)
            return torch.log(torch.clamp(torch.matmul(
                spec.abs().transpose(1, 2), fe.mel_fb), min=cfg.log_offset))

        lib_err = (library() - fl.fused_logmel(*args, packed=packed)).abs().max().item()
        b_ms, b_by = bound_logmel(B, cfg, packed)

        def kernel(calls=1):
            for _ in range(calls):
                fl.fused_logmel(*args, packed=packed)

        def tiled(tile, calls):  # the operator at a given tile, not counted
            for _ in range(calls):
                op(audio, *packed, cfg.input_frames, cfg.num_frames, cfg.hop_length,
                   float(cfg.log_offset), cfg.power == 2.0, tile)

        eager_ms = events_ms(kernel, 10)
        rows[B] = dict(ms=graph_ms(lambda: kernel(calls=4), 4, replays=10),
                       plain_ms=events_ms(lambda: fl.fused_logmel_plain(*args), 10),
                       library_ms=events_ms(library, 10), bound_ms=b_ms,
                       bound_by=b_by)
        r = rows[B]
        log(f"time fused_logmel B={B}: kernel {r['ms']:.4f} ms (CUDA graph; "
            f"eager {eager_ms:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, library (cuFFT route: stft, abs, mel "
            f"matmul, log) {r['library_ms']:.4f} ms (max|diff| to the kernel "
            f"{lib_err:.2e}), bound ({b_by}, fp32 {FP32_FLOPS / 1e12:.0f} "
            f"TFLOP/s outside the tensor cores, {HBM_BYTES_PER_S / 1e12:.2f} "
            f"TB/s) {b_ms:.4f} ms = {b_ms / r['ms']:.1%} of the kernel's time; "
            f"the DFT-GEMM algorithm's operations bound {bound_logmel_dft(B, cfg):.4f} ms")
        chosen = fl.frames_per_cta(B, cfg.num_frames, sms)
        tiles = {tile: graph_ms(lambda: tiled(tile, 4), 4, replays=10)
                 for tile in (2, 4, 8, 16, 32)}
        log(f"  kernel ms by frames per CTA at B={B}: " + ", ".join(
            f"{tile}{'*' if tile == chosen else ''} {ms:.4f}"
            for tile, ms in tiles.items()))
    return rows


def probe_path(dev):
    """The launch probe: exact against its plain version, then its own
    path, the launch-overhead measurement, with its count set to 0 just
    before and read just after. Each launch's output feeds the next
    launch's input: eager through its operator and torch's x + 1 in turns
    (PROBE_ROUNDS chains of each, alternating which goes first, the median
    of each on the device clock between events and on the host clock),
    then each inside one CUDA graph."""
    import torch
    from yourmt3_tpu_torch.ops import launch_probe as lp
    x0 = torch.randn(8, 128, generator=torch.Generator().manual_seed(5)).to(dev)
    got = lp.launch_probe(x0)
    torch.cuda.synchronize()
    assert torch.equal(got, lp.launch_probe_plain(x0))
    n, chain_len = 2000, 100
    fns = {"probe": lp.launch_probe, "torch": lp.launch_probe_plain}

    def chain(fn, k):
        x = torch.zeros(8, 128, device=dev)
        for _ in range(k):
            x = fn(x)
        return x

    def timed_chain(fn):
        """(device ms, host ms) per launch of one chain of n launches."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        last = chain(fn, n)
        end.record()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t) / n * 1e3
        assert torch.equal(last, torch.full_like(last, float(n)))
        return start.elapsed_time(end) / n, host

    lp.launch_probe.launches = 0
    for fn in fns.values():
        timed_chain(fn)  # warm-up
    runs = {name: [] for name in fns}
    for r in range(PROBE_ROUNDS):
        for name in (("probe", "torch") if r % 2 == 0 else ("torch", "probe")):
            runs[name].append(timed_chain(fns[name]))
    out = {name: dict(eager_ms=float(np.median([d for d, _ in rs])),
                      host_ms=float(np.median([h for _, h in rs])),
                      graph_ms=graph_ms(lambda: chain(fns[name], chain_len), chain_len,
                                        replays=20))
           for name, rs in runs.items()}
    launches = lp.launch_probe.launches
    p, t = out["probe"], out["torch"]
    log(f"launch probe (8x128 fp32 x + 1, chained, median of {PROBE_ROUNDS} chains "
        f"of {n} in turns with torch's): kernel eager {p['eager_ms'] * 1e3:.2f} "
        f"us/launch on the device clock ({p['host_ms'] * 1e3:.2f} us on the host "
        f"clock), in a CUDA graph {p['graph_ms'] * 1e3:.2f} us/launch; torch x + 1 "
        f"eager {t['eager_ms'] * 1e3:.2f} us ({t['host_ms'] * 1e3:.2f} us host), in "
        f"a graph {t['graph_ms'] * 1e3:.2f} us; probe launches {launches}")
    log("  device us per launch by chain, probe: " + " ".join(
        f"{d * 1e3:.2f}" for d, _ in runs["probe"]) + "; torch: " + " ".join(
        f"{d * 1e3:.2f}" for d, _ in runs["torch"]))
    assert launches > 0
    nbytes = 2 * 8 * 128 * 4
    return dict(launches=launches, ms=p["eager_ms"], plain_ms=t["eager_ms"],
                library_ms=t["eager_ms"], graph_ms=p["graph_ms"],
                torch_graph_ms=t["graph_ms"],
                bound_ms=max(nbytes / HBM_BYTES_PER_S, 1024 / FP32_FLOPS) * 1e3,
                bound_by="bytes")


def host_us(fn, n: int, rounds: int = 5) -> float:
    """Host µs per eager call: `fn` called `n` times from an idle queue, the
    host clock read before the closing synchronise (n stays far below the
    launch queue's depth, so the host never waits on the device); the
    median of `rounds`."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t) / n * 1e6)
        torch.cuda.synchronize()
    return float(np.median(times))


def wrapper_host_us(dev):
    """Each wrapper's eager host µs per call at its main path's shape
    (paged: S = 8, int8 pages, table bias, pos 1023; int4: S = 104; log-mel:
    B = 16 with packed bases; probe: its tile), beside torch's x + 1."""
    import torch
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops import fused_logmel as fl
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia
    from yourmt3_tpu_torch.ops import launch_probe as lp
    gen = torch.Generator().manual_seed(6)
    pages = make_pages(8, True, gen, dev)
    table = (torch.randn(BUCKETS, H, generator=gen) * 0.5).to(dev)
    dist = da.distance_buckets(BUCKETS, MAXD).to(dev)
    q = torch.randn(8, H, DK, generator=gen).to(dev).to(torch.bfloat16)
    q4 = torch.randn(104, H4, DK4, generator=gen).to(dev).to(torch.bfloat16)
    kv4 = int4_inputs(104, gen, dev)
    fe = logmel_frontend(dev)
    audio = logmel_audio(TRAIN_BATCH, dev)
    bases = (fe.basis_cos, fe.basis_sin, fe.mel_fb, fe.cfg)
    packed = fl.pack_bases(*bases[:3])
    x = torch.zeros(8, 128, device=dev)
    calls = [
        ("paged_decode_attention", 100, lambda: da.paged_decode_attention(
            q, pages["k"], pages["v"], L - 1, rel_table=table, dist_buckets=dist,
            k_scale=pages["ks"], v_scale=pages["vs"])),
        ("int4_cross_attention", 100, lambda: ia.int4_cross_attention(q4, *kv4)),
        ("fused_logmel", 20, lambda: fl.fused_logmel(audio, *bases, packed=packed)),
        ("launch_probe", 100, lambda: lp.launch_probe(x)),
        ("torch x + 1", 100, lambda: x + 1.0),
    ]
    out = {name: host_us(fn, n) for name, n, fn in calls}
    log("eager host us per call (host clock, queue never full): " + ", ".join(
        f"{name} {us:.2f}" for name, us in out.items()))
    return out


# ---------------------------------------------------------------------------
# phases 3-4
# ---------------------------------------------------------------------------

def sine_song(seconds=6.0, sr=16000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    audio = 0.02 * rng.standard_normal(t.shape)
    for f0 in rng.uniform(110.0, 880.0, size=8):
        start = rng.uniform(0, seconds * 0.8)
        env = np.clip((t - start) * 20.0, 0, 1) * np.exp(-np.clip(t - start, 0, None))
        audio += 0.15 * env * np.sin(2 * np.pi * f0 * t)
    return audio.astype(np.float32)


def main_path(tmp):
    import torch
    from yourmt3_tpu_torch.cli import transcribe as cli
    from yourmt3_tpu_torch.data.audio_io import write_wav
    from yourmt3_tpu_torch.models import decoding
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops.int4_cross_attention import int4_cross_attention
    from yourmt3_tpu_torch.ops.kv_quant import int8_decode_attention
    from yourmt3_tpu_torch.tokens.midi_io import midi2note

    seconds = 6.0
    wav = os.path.join(tmp, "song.wav")
    write_wav(wav, sine_song(seconds), 16000)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = cli.main([wav, "-m", "t5_small", "-t", "mt3_full_plus",
                     "--decode-path", "fast", "--repair-beam", "2",
                     "--seed", "0", "-o", tmp])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = da.paged_decode_attention.launches
    int4_launches = int4_cross_attention.launches
    int8_launches = int8_decode_attention.launches
    greedy, beam = decoding.greedy_decode.steps, decoding.beam_decode.steps
    assert len(outs) == 1 and os.path.exists(outs[0]), outs
    notes = midi2note(outs[0])
    log(f"main path: t5_small fast decode, {seconds} s audio in {wall:.2f} s "
        f"(CLI wall incl. init) = {seconds / wall:.3f} audio-s/s; decode "
        f"steps greedy {greedy} + beam {beam}; kernel launches {launches}; "
        f"int8 cross launches {int8_launches}; notes {len(notes)}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    assert launches == 8 * (greedy + beam) and launches > 0, (launches, greedy, beam)
    assert int8_launches == launches, (int8_launches, launches)
    assert int4_launches == 0, int4_launches
    return launches


def reset_counts():
    """Every kernel's launch count and the decode step counts to 0."""
    from yourmt3_tpu_torch.models import decoding
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops import fused_logmel as fl
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia
    from yourmt3_tpu_torch.ops import kv_quant as kq
    from yourmt3_tpu_torch.ops import launch_probe as lp
    da.paged_decode_attention.launches = 0
    ia.int4_cross_attention.launches = 0
    kq.int8_decode_attention.launches = 0
    fl.fused_logmel.launches = 0
    lp.launch_probe.launches = 0
    decoding.greedy_decode.steps = 0
    decoding.beam_decode.steps = 0


def flagship_path(tmp):
    """Phase 3b: the flagship through the public API on a 16 s song."""
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.data.audio_io import write_wav
    from yourmt3_tpu_torch.models import decoding
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia
    from yourmt3_tpu_torch.ops import kv_quant as kq
    from yourmt3_tpu_torch.tokens.midi_io import midi2note

    seconds = 16.0
    wav = os.path.join(tmp, "flagship.wav")
    write_wav(wav, sine_song(seconds), 16000)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = api.init_model("perceiver_tf_mc13", "mc13_full_plus_256", seed=0,
                            **FLAGSHIP)
    t_init = time.perf_counter() - t0
    out = api.transcribe(bundle, wav, os.path.join(tmp, "flagship.mid"),
                         batch_size=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, paged = ia.int4_cross_attention.launches, da.paged_decode_attention.launches
    int8 = kq.int8_decode_attention.launches
    greedy, beam = decoding.greedy_decode.steps, decoding.beam_decode.steps
    assert os.path.exists(out), out
    notes = midi2note(out)
    log(f"main path: perceiver_tf_mc13 int8c4p + int8 weights, {seconds} s audio "
        f"(8 segments, 104 streams) in {wall:.2f} s (init {t_init:.2f} s + "
        f"transcribe {wall - t_init:.2f} s) = {seconds / wall:.3f} audio-s/s "
        f"({seconds / (wall - t_init):.3f} without init); decode steps greedy "
        f"{greedy} + beam {beam}; int4 kernel launches {launches}; dense int8 "
        f"kernel launches {int8}; paged kernel launches {paged}; notes "
        f"{len(notes)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    layers = bundle.cfg.num_decoder_layers
    assert launches == layers * (greedy + beam) and launches > 0, (launches, greedy, beam)
    assert int8 == launches, (int8, launches)  # the self-attention, one a layer
    assert paged == 0, paged
    return launches, int8


def kernel_in_model():
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.data.audio_io import slice_padded_array
    from yourmt3_tpu_torch.ops import decode_attention as da

    paged = api.init_model("t5_small", "mt3_full_plus", seed=0,
                           use_pallas_decode=True)
    dense = dataclasses.replace(paged).with_decode_overrides(use_pallas_decode=False)
    ac = paged.audio_cfg
    segs, _ = slice_padded_array(sine_song(), ac.input_frames)
    batch = np.zeros((8, ac.input_frames), np.float32)
    batch[: len(segs)] = segs
    steps, S = 64, 8
    with torch.no_grad():
        mem = api._encode_batch(dense, batch)
        assert mem.shape == (8, 1, 256, 512) and bool(torch.isfinite(mem).all())
        cd, cp = dense.model.init_cross_kv(mem), paged.model.init_cross_kv(mem)
        kd = dense.model.empty_self_kvs(S, 1024)
        kp = paged.model.empty_self_kvs(S, 1024)
        tok = torch.zeros((S, 1), dtype=torch.long, device=mem.device)
        da.paged_decode_attention.launches = 0
        err, agree = 0.0, 0.0
        for pos in range(steps):
            ld, kd = dense.model.decode_step(tok, pos, kd, cd)
            lp, kp = paged.model.decode_step(tok, pos, kp, cp)
            assert bool(torch.isfinite(lp).all())
            err = max(err, (lp - ld).abs().max().item())
            agree += (lp.argmax(-1) == ld.argmax(-1)).float().mean().item()
            tok = ld.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
    launches = da.paged_decode_attention.launches
    log(f"kernel in model: t5_small bf16, {steps} steps, paged (kernel) vs "
        f"dense: max|logit diff| {err:.4f} (tol {TOL_MODEL_BF16}), same argmax "
        f"{agree / steps:.1%}, kernel launches {launches}")
    assert launches == steps * 16, launches  # 8 self + 8 cross per step
    assert err < TOL_MODEL_BF16, err

    # small fp32 model: the port on the card (kernel) against the port on
    # the CPU (plain versions), same weights and inputs
    gpu = api.init_model("t5_tiny", "mt3_full_plus_256", seed=0,
                         compute_dtype="float32", use_pallas_decode=True)
    cpu = api.init_model("t5_tiny", "mt3_full_plus_256", seed=0, device="cpu",
                         compute_dtype="float32", use_pallas_decode=True)
    err = 0.0
    with torch.no_grad():
        outs = []
        for b in (gpu, cpu):
            mem = api._encode_batch(b, batch[:2])
            cross = b.model.init_cross_kv(mem)
            kv = b.model.empty_self_kvs(2, 256)
            tok = torch.zeros((2, 1), dtype=torch.long, device=mem.device)
            logits = []
            for pos in range(32):
                lg, kv = b.model.decode_step(tok, pos, kv, cross)
                logits.append(lg.cpu())
                tok = torch.full_like(tok, (pos * 37) % 500 + 3)
            outs.append(torch.stack(logits))
        err = (outs[0] - outs[1]).abs().max().item()
    log(f"t5_tiny fp32, 32 paged decode steps: card (kernel) vs CPU (plain): "
        f"max|logit diff| {err:.2e} (tol {TOL_MODEL_FP32})")
    assert err < TOL_MODEL_FP32, err


def flagship_in_model():
    """Phase 4b: 64 bf16 decode steps of the full-width flagship with the
    int4 kernel (int8c4p) against the plain dense int4 path (int8c4: the
    same int4 values, interleaved), on the same memory and tokens; then
    the tiny fp32 flagship on the card against the CPU."""
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.config.model import PERCEIVER_TF_MC13
    from yourmt3_tpu_torch.data.audio_io import slice_padded_array
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia

    kern = api.init_model("perceiver_tf_mc13", "mc13_full_plus_256", seed=0,
                          **FLAGSHIP)
    plain = dataclasses.replace(kern).with_decode_overrides(kv_quant="int8c4")
    segs, _ = slice_padded_array(sine_song(16.0), kern.audio_cfg.input_frames)
    batch = np.ascontiguousarray(segs[:8], np.float32)
    steps, L = 64, kern.task_manager.max_token_length
    with torch.no_grad():
        mem = api._encode_batch(kern, batch)
        assert mem.shape == (8, 13, 256, kern.cfg.d_model) and mem.dtype == torch.bfloat16
        assert bool(torch.isfinite(mem).all())
        S = mem.shape[0] * mem.shape[1]
        ck, cp = kern.model.init_cross_kv(mem), plain.model.init_cross_kv(mem)
        kk, kp = kern.model.empty_self_kvs(S, L), plain.model.empty_self_kvs(S, L)
        tok = torch.zeros((S, 1), dtype=torch.long, device=mem.device)
        ia.int4_cross_attention.launches = 0
        err, agree = 0.0, 0.0
        for pos in range(steps):
            lk, kk = kern.model.decode_step(tok, pos, kk, ck)
            lp, kp = plain.model.decode_step(tok, pos, kp, cp)
            assert bool(torch.isfinite(lk).all())
            err = max(err, (lk - lp).abs().max().item())
            agree += (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
            tok = lp.argmax(-1, keepdim=True)
        torch.cuda.synchronize()
    launches = ia.int4_cross_attention.launches
    log(f"kernel in model: perceiver_tf_mc13 bf16, {steps} steps, S={S}, int8c4p "
        f"(int4 kernel) vs int8c4 (plain dense int4): max|logit diff| {err:.4f} "
        f"(tol {TOL_MODEL_BF16}), same argmax {agree / steps:.1%}, int4 kernel "
        f"launches {launches}")
    assert launches == steps * kern.cfg.num_decoder_layers, launches
    assert err < TOL_MODEL_BF16, err
    del kern, plain, ck, cp, kk, kp

    # tiny fp32 flagship: card (kernel) against CPU (plain versions), the
    # same weights; the decode takes the CPU's memory and int4 cross K/V on
    # both, and each device quantizes its own int8 self cache
    cfg = PERCEIVER_TF_MC13.replace(**TINY_FLAGSHIP)
    kw = dict(model_cfg=cfg, task="mc13_full_plus_256", seed=0,
              compute_dtype="float32", **FLAGSHIP)
    gpu, cpu = api.init_model(**kw), api.init_model(device="cpu", **kw)

    def to_gpu(x):
        return type(x)(to_gpu(y) for y in x) if isinstance(x, (list, tuple)) else x.cuda()

    with torch.no_grad():
        enc = [b.model.encoder(b.frontend(torch.from_numpy(batch[:2]).to(b.device))).cpu()
               for b in (gpu, cpu)]
        err_enc = (enc[0] - enc[1]).abs().max().item()
        mem = api._encode_batch(cpu, batch[:2])
        cross_c = cpu.model.init_cross_kv(mem)
        outs = []
        for b, cross in ((gpu, to_gpu(cross_c)), (cpu, cross_c)):
            kv = b.model.empty_self_kvs(26, 256)
            tok = torch.zeros((26, 1), dtype=torch.long, device=b.device)
            logits = []
            for pos in range(32):
                lg, kv = b.model.decode_step(tok, pos, kv, cross)
                logits.append(lg.cpu())
                tok = torch.full_like(tok, (pos * 37) % 500 + 3)
            outs.append(torch.stack(logits))
        err = (outs[0] - outs[1]).abs().max().item()
    log(f"tiny flagship fp32, card vs CPU: encoder max|diff| {err_enc:.2e} (tol "
        f"{TOL_MODEL_FP32}); 32 int8c4p decode steps (card: int4 kernel, CPU: "
        f"plain) max|logit diff| {err:.2e} (tol {TOL_MODEL_INT8})")
    assert err_enc < TOL_MODEL_FP32, err_enc
    assert err < TOL_MODEL_INT8, err


def device_profile(fn):
    """Run `fn` under torch.profiler; → (device events, {name: (count,
    total µs)}) from its chrome trace (kernels, copies, memsets)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    trace = os.path.join(tempfile.gettempdir(), f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    os.remove(trace)
    dev_events = [e for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_name = {}
    for e in dev_events:
        cnt, dur = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (cnt + 1, dur + e["dur"])
    return dev_events, by_name


def where_time_goes(label, bundle, audio, first, kernel):
    """Phase 5 for one path: its stages on the host clock, each ended by a
    synchronise, then a window of 32 decode steps from position `first`
    under torch.profiler: device busy time per step, the device's idle
    share, and the kernels that take the device's time (`kernel` names the
    path's own)."""
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.data.audio_io import slice_padded_array
    from yourmt3_tpu_torch.models import decoding

    tm, ac, model = bundle.task_manager, bundle.audio_cfg, bundle.model
    tm_len = tm.max_token_length
    segs, starts = slice_padded_array(audio, ac.input_frames)
    starts = (starts / ac.sample_rate).tolist()
    batch = np.zeros((8, ac.input_frames), np.float32)
    batch[: len(segs)] = segs[:8]
    segs, starts = segs[:8], starts[:8]
    prefix = tm.subtask_prefix_ids(None)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    with torch.no_grad():
        mem, t_enc = timed(lambda: api._encode_batch(bundle, batch))
        ids, t_greedy = timed(lambda: decoding.greedy_decode(
            model, mem, tm_len, prefix_ids=prefix))
        seg_ids = ids.cpu().numpy()[: len(segs)]
        _, t_detok = timed(lambda: tm.detokenize_song(seg_ids, starts))
        steps = decoding.beam_decode.steps
        _, t_repair = timed(lambda: api._repair_error_segments(
            bundle, segs, seg_ids, starts, prefix, tm_len, 8, 2))
        steps = decoding.beam_decode.steps - steps
        log(f"stages {label} (host clock): frontend+encoder {t_enc:.3f} s, greedy "
            f"decode {t_greedy:.3f} s ({tm_len} steps, "
            f"{t_greedy / tm_len * 1e3:.2f} ms/step), detokenize {t_detok:.3f} s, "
            f"beam-2 repair {t_repair:.3f} s ({steps} steps)")
    decode_window(label, model, mem, tm_len, first, kernel)


def decode_window(label, model, mem, max_len, first, kernel):
    """32 decode steps from position `first` on `mem` under torch.profiler:
    host ms per step, device busy time per step, the device's idle share,
    and the kernels that take the device's time (`kernel` names the
    path's own)."""
    import torch

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t

    with torch.no_grad():
        cross = model.init_cross_kv(mem)
        S = mem.shape[0] * mem.shape[1]
        kv = model.empty_self_kvs(S, max_len)
        tok = torch.zeros((S, 1), dtype=torch.long, device=mem.device)
        n = 32

        def window():
            nonlocal kv
            for pos in range(first, first + n):
                logits, kv = model.decode_step(tok, pos, kv, cross)
                tok.copy_(logits.argmax(-1, keepdim=True))

        window()  # warm-up
        wall = timed(window)
        dev_events, by_name = device_profile(window)
    if not dev_events:
        log(f"decode window {label}: the profiler saw no device events; device "
            "busy time and idle share not measured")
        return
    busy_ms = sum(d for _, d in by_name.values()) / 1e3 / n
    wall_ms = wall * 1e3 / n
    kern_ms = sum(d for name, (_, d) in by_name.items()
                  if kernel in name) / 1e3 / n
    log(f"decode window {label} pos {first}-{first + n - 1} (S={S}): host "
        f"{wall_ms:.3f} ms/step; device busy {busy_ms:.3f} ms/step; device idle "
        f"{1 - busy_ms / wall_ms:.1%}; {len(dev_events) / n:.0f} device ops/step; "
        f"{kernel} {kern_ms:.4f} ms/step = {kern_ms / busy_ms:.1%} of device busy")
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1][1])[:8]
    for name, (cnt, dur) in top:
        log(f"  {dur / 1e3 / n:.4f} ms/step  {cnt / n:5.1f}/step  {name[:90]}")


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

class StepLog:
    """A trainer logger that keeps every logged step's metrics and time."""

    def __init__(self):
        self.records = []

    def log(self, step, metrics, prefix=""):
        self.records.append((step, time.perf_counter(), dict(metrics)))

    def close(self):
        pass


def build_synth_sets(root):
    """The flagship's synthetic multi-instrument set (preset synth_mc) and
    the smoke set (synth_smoke), built by the port's copy of the builder."""
    from yourmt3_tpu_torch.data.preprocess.synth import build_synth_dataset
    build_synth_dataset(root, n_tracks=4, duration=8.0, splits=("train",),
                        programs=SYNTH_MC_PROGRAMS, seed=0,
                        dataset_name="synthmc")
    build_synth_dataset(root, n_tracks=2, duration=6.0, splits=("train",), seed=1)


def train_path(tmp):
    """Phase 6: the full-width flagship trains through trainer.train with
    the fused log-mel frontend; → the kernel's launches and the numbers."""
    import itertools
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.config.data_presets import get_data_preset
    from yourmt3_tpu_torch.data.dataset_train import TrainDataset
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops import fused_logmel as fl
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia
    from yourmt3_tpu_torch.ops import kv_quant as kq
    from yourmt3_tpu_torch.ops.frontend import SpectrogramFrontend
    from yourmt3_tpu_torch.train.trainer import train

    data = os.path.join(tmp, "data")
    os.environ["YMT3_DATA_HOME"] = data
    t0 = time.perf_counter()
    build_synth_sets(data)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    bundle = api.init_model("perceiver_tf_mc13", "mc13_full_plus_256", seed=0)
    bundle.frontend = SpectrogramFrontend.from_config(
        bundle.audio_cfg, use_pallas=True, device=bundle.device)
    t_init = time.perf_counter() - t0
    ds = TrainDataset(get_data_preset("synth_mc").index_files("train"),
                      bundle.task_manager, bundle.audio_cfg, seed=0)
    batch = ds.make_batch(TRAIN_BATCH)
    tokens = int((batch["labels"] != 0).sum())
    head0 = bundle.model.lm_head.weight.detach().clone()
    steps = StepLog()
    ckpt_dir = os.path.join(tmp, "flagship_run")

    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train(bundle, itertools.repeat(batch), total_steps=TRAIN_STEPS, log_every=1,
          ckpt_every=TRAIN_STEPS, ckpt_dir=ckpt_dir, base_lr=1e-3,
          warmup_steps=2, seed=0, logger=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fl.fused_logmel.launches
    others = (da.paged_decode_attention.launches, ia.int4_cross_attention.launches,
              kq.int8_decode_attention.launches)
    peak = torch.cuda.max_memory_allocated() / 2**20

    losses = [m["loss"] for _, _, m in steps.records]
    gnorms = [m["grad_norm"] for _, _, m in steps.records]
    (_, t_first, _), (_, t_last, _) = steps.records[0], steps.records[-1]
    sps = (len(steps.records) - 1) / (t_last - t_first)
    log(f"train perceiver_tf_mc13 (bf16 compute, fp32 master, batch "
        f"{TRAIN_BATCH}, fused log-mel frontend, one repeated synth batch of "
        f"{tokens} target tokens): {TRAIN_STEPS} steps in {wall:.2f} s (synth "
        f"set {t_data:.2f} s, init {t_init:.2f} s before); steady "
        f"{sps:.3f} steps/s = {sps * tokens:.0f} target tokens/s (steps "
        f"2-{TRAIN_STEPS}); fused_logmel launches {launches}; peak device "
        f"memory {peak:.1f} MiB")
    log(f"  loss by step: {' '.join(f'{x:.3f}' for x in losses)}")
    log(f"  grad_norm by step: {' '.join(f'{x:.2f}' for x in gnorms)}")
    assert launches == TRAIN_STEPS, launches
    assert others == (0, 0, 0), others
    assert all(np.isfinite(losses)) and all(np.isfinite(gnorms))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert not torch.equal(bundle.model.lm_head.weight, head0)

    serve_from_checkpoint(tmp, os.path.join(ckpt_dir, "last"), bundle)
    profile_train_steps(bundle, batch)
    del bundle
    torch.cuda.empty_cache()
    cli_train_steps(tmp)
    return dict(launches=launches, steps_per_s=sps, tokens_per_s=sps * tokens,
                peak_mib=peak, loss_first=losses[0], loss_last=losses[-1],
                batch=batch)


def serve_from_checkpoint(tmp, ckpt, trained):
    """Restore the trained checkpoint with the flagship's decode settings;
    the int8 side-car weights must be those of the trained masters; then
    transcribe a 2 s song through the int4 kernel."""
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.data.audio_io import write_wav
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia
    from yourmt3_tpu_torch.ops.weight_quant import quantize_int8
    from yourmt3_tpu_torch.tokens.midi_io import midi2note

    t0 = time.perf_counter()
    served = api.load_checkpoint(ckpt, **FLAGSHIP)
    t_load = time.perf_counter() - t0
    head, master = served.model.lm_head, trained.model.lm_head.weight
    q, scale = quantize_int8(master)
    assert torch.equal(head.weight, master)
    assert torch.equal(head.weight_q, q) and torch.equal(head.weight_scale, scale)
    wav = os.path.join(tmp, "served.wav")
    write_wav(wav, sine_song(2.0, seed=3), 16000)
    ia.int4_cross_attention.launches = 0
    t0 = time.perf_counter()
    out = api.transcribe(served, wav, os.path.join(tmp, "served.mid"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ia.int4_cross_attention.launches
    notes = midi2note(out)
    log(f"served the trained checkpoint (load_checkpoint with int8c4p K/V, "
        f"int8 weights rebuilt from the trained masters, {t_load:.2f} s): 2 s "
        f"song in {wall:.2f} s, int4 kernel launches {launches}, notes "
        f"{len(notes)}")
    assert os.path.exists(out) and launches > 0


def profile_train_steps(bundle, batch):
    """A window of PROFILED_STEPS train steps (after one warm-up): host
    time per step, the device's busy time and idle share, top ops."""
    import torch
    from yourmt3_tpu_torch.ops.specaugment import make_augment_fn
    from yourmt3_tpu_torch.train.optim import make_optimizer
    from yourmt3_tpu_torch.train.train_step import create_train_state, make_train_step
    model = bundle.model
    tx = make_optimizer("adamw", 1e-4, "constant")
    step_fn = make_train_step(model, bundle.frontend, tx, augment_fn=make_augment_fn())
    state = [create_train_state(model, tx)]
    gen = torch.Generator(device=bundle.device).manual_seed(1)

    def window():
        for _ in range(PROFILED_STEPS):
            state[0], metrics = step_fn(state[0], batch, gen)
        return metrics

    window()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / PROFILED_STEPS
    dev_events, by_name = device_profile(window)
    model.eval()
    if not dev_events:
        log("train window: the profiler saw no device events; device busy "
            "time and idle share not measured")
        return
    busy_ms = sum(d for _, d in by_name.values()) / 1e3 / PROFILED_STEPS
    logmel_ms = sum(d for name, (_, d) in by_name.items()
                    if "fused_logmel" in name) / 1e3 / PROFILED_STEPS
    log(f"train window ({PROFILED_STEPS} steps, batch {TRAIN_BATCH}): host "
        f"{host_ms:.2f} ms/step; device busy {busy_ms:.2f} ms/step; device "
        f"idle {1 - busy_ms / host_ms:.1%}; {len(dev_events) / PROFILED_STEPS:.0f} "
        f"device ops/step; fused_logmel {logmel_ms:.3f} ms/step = "
        f"{logmel_ms / busy_ms:.1%} of device busy")
    top = sorted(by_name.items(), key=lambda kv_: -kv_[1][1])[:10]
    for name, (cnt, dur) in top:
        log(f"  {dur / 1e3 / PROFILED_STEPS:.3f} ms/step  "
            f"{cnt / PROFILED_STEPS:6.1f}/step  {name[:90]}")


def cli_train_steps(tmp):
    """Two steps of `cli.train` at t5_small width on the smoke synth set,
    its batches made by two spawned producer processes under this process's
    CUDA context (`--num-workers 2`); cli.train stops them when it ends."""
    import multiprocessing as mp
    from yourmt3_tpu_torch.cli import train as cli_train
    from yourmt3_tpu_torch.train.checkpoint import restore_opt_state
    t0 = time.perf_counter()
    run = cli_train.main(["smoke", "-d", "synth_smoke", "-m", "t5_small",
                          "-b", "16", "-s", "2", "--warmup-steps", "1",
                          "--log-every", "1", "--ckpt-every", "2",
                          "--num-workers", "2",
                          "--ckpt-dir", os.path.join(tmp, "cli_run")])
    wall = time.perf_counter() - t0
    with open(os.path.join(run, "smoke_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    deadline = time.perf_counter() + 10.0
    while mp.active_children() and time.perf_counter() < deadline:
        time.sleep(0.1)
    left = mp.active_children()
    log(f"cli.train t5_small, batch 16, 2 producer processes, 2 steps in "
        f"{wall:.2f} s (incl. init, the producers' start and data): losses "
        f"{[round(r['loss'], 4) for r in recs]}; checkpoint at step "
        f"{restore_opt_state(os.path.join(run, 'last'))['step']}; producers left "
        f"running {len(left)}")
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert restore_opt_state(os.path.join(run, "last"))["step"] == 2
    assert not left, left


# ---------------------------------------------------------------------------
# phase 7: evaluation
# ---------------------------------------------------------------------------

def bf16_ulp(x: float) -> float:
    return 2.0 ** (np.floor(np.log2(max(abs(x), 2.0 ** -126))) - 7)


def eval_path(tmp, dev, smi):
    """Phase 7: cli.test scores phase 6's flagship checkpoint on a test
    split of synth_mc; early exit against plain greedy on a training
    song; the decode kernels' batch invariance under compaction."""
    import torch
    from yourmt3_tpu_torch.cli import test as cli_test
    from yourmt3_tpu_torch.data.preprocess.synth import build_synth_dataset
    from yourmt3_tpu_torch.models import decoding
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia
    from yourmt3_tpu_torch.train.checkpoint import read_meta

    data = os.environ["YMT3_DATA_HOME"]
    ckpt = os.path.join(tmp, "flagship_run", "last")
    layers = read_meta(ckpt)["model"]["num_decoder_layers"]
    seconds, n_tracks = 8.0, 2
    build_synth_dataset(data, n_tracks=n_tracks, duration=seconds,
                        splits=("test",), programs=SYNTH_MC_PROGRAMS, seed=7,
                        dataset_name="synthmc")
    out_json = os.path.join(tmp, "eval.json")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = cli_test.main(["-ckpt", ckpt, "-d", "synth_mc", "--split", "test",
                             "--kv-quant", "int8c4p", "--weight-quant", "int8",
                             "-b", "8", "--output-json", out_json])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, paged = ia.int4_cross_attention.launches, da.paged_decode_attention.launches
    greedy, beam = decoding.greedy_decode.steps, decoding.beam_decode.steps
    with open(out_json) as f:
        res = json.load(f)["synthmc"]
    assert res == json.loads(json.dumps(results["synthmc"]))
    missing = [k for k in EVAL_KEYS if k not in res]
    assert not missing, missing
    assert sorted(res.get("offset_diagnostic", {"n_pairs": 0.0})) in (
        sorted(OFFSET_KEYS), ["n_pairs"]), res.get("offset_diagnostic")
    assert res["num_tracks"] == n_tracks, res
    assert all(np.isfinite(v) for v in res.values() if isinstance(v, float)), res
    audio_s = seconds * n_tracks
    log(f"[{smi}] cli.test perceiver_tf_mc13 int8c4p + int8 weights, phase 6 "
        f"checkpoint, synth_mc test split ({n_tracks} tracks of {seconds} s, "
        f"batch 8): {wall:.2f} s incl. load = {audio_s / wall:.3f} audio-s/s; "
        f"decode steps greedy {greedy} + beam {beam}; int4 kernel launches "
        f"{launches}; paged kernel launches {paged}; "
        + " ".join(f"{k}={v:.4f}" for k, v in res.items() if isinstance(v, float))
        + f"; offset_diagnostic {res.get('offset_diagnostic', 'absent (no pairs)')}")
    assert launches == layers * (greedy + beam) and launches > 0, (launches, greedy, beam)
    assert paged == 0, paged
    early_exit_vs_plain(ckpt, os.path.join(data, "synthmc", "train",
                                           "synthmc_train_000.wav"), smi)
    batch_invariance(dev, smi)
    return dict(launches=launches, wall=wall, audio_s=audio_s)


class Top2Recorder:
    """Wraps a model's decode_step while active: keeps each step's top two
    logits per stream, (steps, S, 2). The decode loops take their eager
    step meanwhile: a replayed CUDA graph of the step does not call
    decode_step from Python (the tokens are the same)."""

    def __init__(self, model):
        self.model, self.rows = model, []

    def __enter__(self):
        import torch
        from yourmt3_tpu_torch.models import decoding
        step = self.model.decode_step

        def recording(*a, **kw):
            logits, kvs = step(*a, **kw)
            self.rows.append(torch.topk(logits, 2, dim=-1).values)
            return logits, kvs

        self.model.decode_step = recording
        self.graphable = decoding._graphable
        decoding._graphable = lambda *a: False
        return self

    def __exit__(self, *exc):
        from yourmt3_tpu_torch.models import decoding
        del self.model.decode_step
        decoding._graphable = self.graphable

    def values(self):
        import torch
        return torch.stack(self.rows).float().cpu().numpy()


def parting_streams(label, plain, early, top2, names=("plain", "early exit")):
    """Streams whose early-exit ids differ from the plain decode's: each is
    printed with its first differing step and the plain decode's top-two
    logit margin there; → (identical streams, the widest margin in bf16
    ulps). `names` name the two decodes in the printout (another pair of
    decodes of the same streams, the first the one whose margins top2
    holds)."""
    a = plain.reshape(-1, plain.shape[-1]).cpu().numpy()
    b = early.reshape(-1, early.shape[-1]).cpu().numpy()
    worst = 0.0
    parted = np.nonzero((a != b).any(axis=1))[0]
    for s in parted:
        j = int(np.argmax(a[s] != b[s]))
        hi, lo = top2[j, s]
        ulps = (hi - lo) / bf16_ulp(hi)
        worst = max(worst, ulps)
        log(f"  {label}: stream {s} parts at step {j}: {names[0]} {a[s, j]} vs "
            f"{names[1]} {b[s, j]}; {names[0]} top-two logits {hi:.6f} / {lo:.6f}, "
            f"margin {ulps:.2f} bf16 ulps (limit {MARGIN_ULPS})")
    return a.shape[0] - len(parted), worst


def stop_token(ids, prefix_len, max_length):
    """(token, chunk, threshold): a token of the plain decode at which
    stopping leaves some streams running after a chunk boundary while the
    rest, padded to a power-of-two multiple of 8, fit in `threshold` of
    the rows: the defaults (64, 0.5) first, then shorter chunks, then the
    threshold 1.0 of the tests."""
    rows = ids.reshape(-1, ids.shape[-1])[:, prefix_len:]
    S = rows.shape[0]
    tokens, counts = np.unique(rows, return_counts=True)
    for threshold in (0.5, 1.0):
        for chunk in (64, 32, 16, 8):
            for tok in tokens[np.argsort(-counts, kind="stable")]:
                hit = rows == tok
                first = np.where(hit.any(axis=1), hit.argmax(axis=1) + prefix_len,
                                 max_length)
                for k in range(1, max_length // chunk):
                    active = int((first >= k * chunk).sum())
                    padded = 8
                    while padded < active:
                        padded *= 2
                    if 0 < active and padded <= threshold * S:
                        return int(tok), chunk, threshold
    raise AssertionError("no token of the plain decode stops the streams apart")


def early_exit_vs_plain(ckpt, wav, smi):
    """Phase 7e: api.transcribe_audio_array with and without early_exit
    (repair off) on one training song, the ids taken from the API's own
    decoder calls; then, because phase 6's checkpoint ends every stream
    at its second token (so nothing is left to compact), the early-exit
    decode at a stop token on the full-width flagship of phase 3b (the
    int4 kernel) and on t5_small's fast path (the paged kernel, 48 streams
    whose compaction changes its range split). The plain decodes keep
    their top two logits per step for the margin rule."""
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.data.audio_io import load_audio_file
    from yourmt3_tpu_torch.models import decoding
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia

    bundle = api.load_checkpoint(ckpt, **FLAGSHIP)
    layers = bundle.cfg.num_decoder_layers
    audio, sr = load_audio_file(wav, bundle.audio_cfg.sample_rate)
    ids, rec = {}, Top2Recorder(bundle.model)
    plain_fn, early_fn = api.greedy_decode, api.greedy_decode_early_exit

    def plain(*a, **kw):
        with rec:
            ids["plain"] = plain_fn(*a, **kw)
        return ids["plain"]

    def early(*a, **kw):
        ids["early"] = early_fn(*a, **kw)
        return ids["early"]

    api.greedy_decode, api.greedy_decode_early_exit = plain, early
    walls, notes = {}, {}
    try:
        for name, flag in (("plain", False), ("early", True)):
            reset_counts()
            decoding.greedy_decode_early_exit.compactions = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            notes[name], _ = api.transcribe_audio_array(
                bundle, audio, sr, batch_size=8, early_exit=flag, repair_beam=0)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            steps, launches = decoding.greedy_decode.steps, ia.int4_cross_attention.launches
            assert launches == layers * steps and steps > 0, (name, launches, steps)
            walls[name + "_steps"] = steps
    finally:
        api.greedy_decode, api.greedy_decode_early_exit = plain_fn, early_fn
    same, worst = parting_streams("checkpoint", ids["plain"], ids["early"], rec.values())
    lengths = (ids["plain"] != 0).sum(-1)
    log(f"[{smi}] early exit vs plain greedy through api.transcribe_audio_array, "
        f"perceiver_tf_mc13 int8c4p + int8 weights, phase 6 checkpoint, "
        f"{len(audio) / sr:.2f} s training song ({lengths.numel()} streams, "
        f"lengths {int(lengths.min())}-{int(lengths.max())} tokens): plain "
        f"{walls['plain']:.3f} s ({walls['plain_steps']} steps), early exit "
        f"{walls['early']:.3f} s ({walls['early_steps']} steps, "
        f"{decoding.greedy_decode_early_exit.compactions} compactions); {same} of "
        f"{lengths.numel()} streams identical; notes {len(notes['plain'])} / "
        f"{len(notes['early'])}")
    assert worst <= MARGIN_ULPS, worst
    if same == lengths.numel():
        assert notes["plain"] == notes["early"]
    del bundle
    for preset, task, overrides, seconds, rows, L, kernel in (
            ("perceiver_tf_mc13", "mc13_full_plus_256", FLAGSHIP, 16.0, 8, 256,
             ia.int4_cross_attention),
            ("t5_small", "mt3_full_plus", api.fast_decode_overrides(1, 1024),
             100.0, 48, 512, da.paged_decode_attention)):
        fresh = api.init_model(preset, task, seed=0, **overrides)
        early_exit_at_stop_token(fresh, sine_song(seconds), rows, L, kernel, smi)
        del fresh


def early_exit_at_stop_token(bundle, audio, rows, L, kernel, smi):
    """greedy_decode_early_exit against greedy_decode (both given the same
    memory and cross K/V) on the first `rows` segments of `audio`, to
    step L, stopping at stop_token's choice; `kernel` is the wrapper of
    the path's kernel, whose launches must be one per decoder layer and
    step."""
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.data.audio_io import slice_padded_array
    from yourmt3_tpu_torch.models import decoding

    model, prefix = bundle.model, bundle.task_manager.subtask_prefix_ids()
    segs, _ = slice_padded_array(audio, bundle.audio_cfg.input_frames)
    assert len(segs) >= rows, (len(segs), rows)
    ids, walls = {}, {}
    with torch.no_grad():
        mem = api._encode_batch(bundle, np.ascontiguousarray(segs[:rows], np.float32))
        cross = model.init_cross_kv(mem)
        free = decoding.greedy_decode(model, mem, L, prefix_ids=prefix, cross_kvs=cross)
        stop, chunk, threshold = stop_token(free.cpu().numpy(), len(prefix), L)
        for name in ("plain", "early"):
            reset_counts()
            decoding.greedy_decode_early_exit.compactions = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "plain":
                with Top2Recorder(model) as rec:
                    ids[name] = decoding.greedy_decode(
                        model, mem, L, prefix_ids=prefix, eos_id=stop, cross_kvs=cross)
            else:
                ids[name] = decoding.greedy_decode_early_exit(
                    model, mem, L, prefix_ids=prefix, eos_id=stop, chunk=chunk,
                    compact_threshold=threshold, cross_kvs=cross)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            steps, launches = decoding.greedy_decode.steps, kernel.launches
            assert launches == bundle.cfg.num_decoder_layers * steps and steps > 0, (
                name, launches, steps)
            walls[name + "_steps"] = steps
    compactions = decoding.greedy_decode_early_exit.compactions
    label = f"{bundle.cfg.name} {bundle.cfg.kv_quant}"
    same, worst = parting_streams(label, ids["plain"], ids["early"], rec.values())
    lengths = (ids["plain"] != 0).sum(-1)
    log(f"[{smi}] early exit vs plain greedy, full-width {label} "
        f"(use_pallas_decode={bundle.cfg.use_pallas_decode}, weights "
        f"{bundle.cfg.weight_quant}, random from seed 0), {rows} segments of a "
        f"sine song, L {L}, stop token {stop}, chunk {chunk}, threshold "
        f"{threshold} ({lengths.numel()} streams, lengths {int(lengths.min())}-"
        f"{int(lengths.max())} tokens): plain {walls['plain']:.3f} s "
        f"({walls['plain_steps']} steps), early exit {walls['early']:.3f} s "
        f"({walls['early_steps']} steps, {compactions} compactions); {same} of "
        f"{lengths.numel()} streams identical; {kernel.__name__} launches "
        f"{kernel.launches} in the early-exit run")
    assert compactions >= 1, compactions
    assert worst <= MARGIN_ULPS, worst


def batch_invariance(dev, smi):
    """Phase 7f: each decode kernel on a full batch and on the kept
    streams of a compacted one (the cache rows gathered as the cache
    layouts gather them: pages on axis 1, everything else on axis 0); max
    |diff| of the kept rows."""
    import torch
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia
    gen = torch.Generator().manual_seed(9)
    full = 48
    table = (torch.randn(BUCKETS, H, generator=gen) * 0.5).to(dev)
    dist = da.distance_buckets(BUCKETS, MAXD).to(dev)
    pages = make_pages(full, True, gen, dev)
    q = torch.randn(full, H, DK, generator=gen).to(dev).to(torch.bfloat16)
    for pos in (511, 1023):
        want = da.paged_decode_attention(q, pages["k"], pages["v"], pos,
                                         rel_table=table, dist_buckets=dist,
                                         k_scale=pages["ks"], v_scale=pages["vs"])
        for kept in (8, 16):
            idx = torch.randperm(full, generator=gen)[:kept].sort().values.to(dev)
            k, v = (pages[n].index_select(1, idx) for n in ("k", "v"))
            ks, vs = (pages[n].index_select(0, idx) for n in ("ks", "vs"))
            got = da.paged_decode_attention(q[idx], k, v, pos, rel_table=table,
                                            dist_buckets=dist, k_scale=ks, v_scale=vs)
            diff = (got.float() - want[idx].float()).abs().max().item()
            log(f"[{smi}] batch invariance, paged kernel (t5_small width, int8 "
                f"pages, pos {pos}, {da.decode_splits(L)[0]} ranges): {kept} of "
                f"{full} streams vs the full batch: max|diff| {diff:.3e}")
            assert torch.equal(got, want[idx]), (pos, kept, diff)
    full = 104
    kv = int4_inputs(full, gen, dev)
    q = torch.randn(full, H4, DK4, generator=gen).to(dev).to(torch.bfloat16)
    want = ia.int4_cross_attention(q, *kv)
    for kept in (8, 16):
        idx = torch.randperm(full, generator=gen)[:kept].sort().values.to(dev)
        got = ia.int4_cross_attention(q[idx], *(x.index_select(0, idx) for x in kv))
        diff = (got.float() - want[idx].float()).abs().max().item()
        log(f"[{smi}] batch invariance, int4 cross kernel (S {full}, T {T4}): "
            f"{kept} of {full} streams vs the full batch: max|diff| {diff:.3e}")
        assert torch.equal(got, want[idx]), (kept, diff)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 8: the MoE flagship and the conformer
# ---------------------------------------------------------------------------

def moe_flagship_path(tmp, smi):
    """Phase 8a: the MoE flagship through the public API on phase 3b's
    song, then its encoder's device time and the MoE FFs' share of it."""
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.data.audio_io import slice_padded_array, write_wav
    from yourmt3_tpu_torch.models import decoding
    from yourmt3_tpu_torch.models.layers import MoEFeedForward
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia
    from yourmt3_tpu_torch.tokens.midi_io import midi2note

    seconds = 16.0
    audio = sine_song(seconds)
    wav = os.path.join(tmp, "moe.wav")
    write_wav(wav, audio, 16000)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bundle = api.init_model("perceiver_tf_mc13_moe", "mc13_full_plus_256",
                            seed=0, **FLAGSHIP)
    t_init = time.perf_counter() - t0
    out = api.transcribe(bundle, wav, os.path.join(tmp, "moe.mid"), batch_size=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    launches, paged = ia.int4_cross_attention.launches, da.paged_decode_attention.launches
    greedy, beam = decoding.greedy_decode.steps, decoding.beam_decode.steps
    assert os.path.exists(out), out
    notes = midi2note(out)
    log(f"[{smi}] phase 8a: perceiver_tf_mc13_moe int8c4p + int8 weights, "
        f"{seconds} s audio (8 segments, 104 streams) in {wall:.2f} s (init "
        f"{t_init:.2f} s + transcribe {wall - t_init:.2f} s) = "
        f"{seconds / wall:.3f} audio-s/s ({seconds / (wall - t_init):.3f} "
        f"without init); decode steps greedy {greedy} + beam {beam}; int4 "
        f"kernel launches {launches}; paged kernel launches {paged}; notes "
        f"{len(notes)}; peak device memory {peak:.1f} MiB")
    layers = bundle.cfg.num_decoder_layers
    assert launches == layers * (greedy + beam) and launches > 0, (launches, greedy, beam)
    assert paged == 0, paged

    segs, _ = slice_padded_array(audio, bundle.audio_cfg.input_frames)
    batch = np.ascontiguousarray(segs[:8], np.float32)
    model = bundle.model
    moe = [m for m in model.encoder.modules() if isinstance(m, MoEFeedForward)]
    inputs = []
    hooks = [m.register_forward_pre_hook(lambda m, args: inputs.append((m, args[0])))
             for m in moe]
    with torch.no_grad():
        feats = bundle.frontend(torch.from_numpy(batch).to(bundle.device))
        model.encoder(feats)  # warm-up; keeps each MoE FF's input
        for h in hooks:
            h.remove()
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.encoder(feats)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) * 1e3
        _, enc = device_profile(lambda: model.encoder(feats))
        _, ff = device_profile(lambda: [m(x) for m, x in inputs])
    enc_ms = sum(d for _, d in enc.values()) / 1e3
    moe_ms = sum(d for _, d in ff.values()) / 1e3
    rows = inputs[0][1].shape[0] * inputs[0][1].shape[1]
    log(f"[{smi}] phase 8a encoder (batch 8, {len(moe)} MoE FFs of {rows} "
        f"rows): host {host_ms:.2f} ms; device busy {enc_ms:.2f} ms; the MoE "
        f"FFs alone {moe_ms:.2f} ms = {moe_ms / enc_ms:.1%} of it")
    top = sorted(enc.items(), key=lambda kv_: -kv_[1][1])[:6]
    for name, (cnt, dur) in top:
        log(f"  {dur / 1e3:.3f} ms  {cnt:4d}x  {name[:90]}")
    with torch.no_grad():
        mem = model.projection(model.encoder(feats))
    decode_window("perceiver_tf_mc13_moe", model, mem,
                  bundle.task_manager.max_token_length, 112, "int4_cross_kernel")
    return dict(launches=launches, wall=wall, audio_s=seconds, peak=peak,
                enc_ms=enc_ms, moe_ms=moe_ms)


def conformer_path(tmp, smi):
    """Phase 8b: conformer_small through the CLI's fast decode path on
    phase 3a's song."""
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.cli import transcribe as cli
    from yourmt3_tpu_torch.data.audio_io import slice_padded_array, write_wav
    from yourmt3_tpu_torch.models import decoding
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops.int4_cross_attention import int4_cross_attention
    from yourmt3_tpu_torch.tokens.midi_io import midi2note

    seconds = 6.0
    wav = os.path.join(tmp, "conformer.wav")
    write_wav(wav, sine_song(seconds), 16000)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs = cli.main([wav, "-m", "conformer_small", "-t", "mt3_full_plus",
                     "--decode-path", "fast", "--repair-beam", "2",
                     "--seed", "0", "-o", tmp])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20
    launches = da.paged_decode_attention.launches
    int4_launches = int4_cross_attention.launches
    greedy, beam = decoding.greedy_decode.steps, decoding.beam_decode.steps
    assert len(outs) == 1 and os.path.exists(outs[0]), outs
    notes = midi2note(outs[0])
    log(f"[{smi}] phase 8b: conformer_small fast decode, {seconds} s audio in "
        f"{wall:.2f} s (CLI wall incl. init) = {seconds / wall:.3f} audio-s/s; "
        f"decode steps greedy {greedy} + beam {beam}; paged kernel launches "
        f"{launches}; notes {len(notes)}; peak device memory {peak:.1f} MiB")
    assert launches == 8 * (greedy + beam) and launches > 0, (launches, greedy, beam)
    assert int4_launches == 0, int4_launches

    # the same model again: its encoder's device time on a batch of 8, then
    # a profiled window of its decode steps
    bundle = api.init_model("conformer_small", "mt3_full_plus", seed=0,
                            **api.fast_decode_overrides(1, 1024))
    segs, _ = slice_padded_array(sine_song(16.0), bundle.audio_cfg.input_frames)
    with torch.no_grad():
        feats = bundle.frontend(torch.from_numpy(
            np.ascontiguousarray(segs[:8], np.float32)).to(bundle.device))
        bundle.model.encoder(feats)  # warm-up
        _, enc = device_profile(lambda: bundle.model.encoder(feats))
        mem = bundle.model.encode(feats)
    enc_ms = sum(d for _, d in enc.values()) / 1e3
    log(f"[{smi}] phase 8b encoder (batch 8): device busy {enc_ms:.2f} ms")
    decode_window("conformer_small", bundle.model, mem,
                  bundle.task_manager.max_token_length, 496, "paged_decode")
    return dict(launches=launches, wall=wall, audio_s=seconds, peak=peak,
                enc_ms=enc_ms)


def options_card_vs_cpu(smi):
    """Phase 8c: each option of OPTIONS at full width in fp32, the card
    against the CPU on one seeded batch, the same weights."""
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.data.audio_io import slice_padded_array

    for preset, task, ov in OPTIONS:
        t0 = time.perf_counter()
        kw = dict(seed=0, compute_dtype="float32", **ov)
        gpu = api.init_model(preset, task, **kw)
        cpu = api.init_model(preset, task, device="cpu", **kw)
        segs, _ = slice_padded_array(sine_song(16.0), gpu.audio_cfg.input_frames)
        enc_msg = encoder_card_vs_cpu(gpu, cpu, np.ascontiguousarray(segs[:2], np.float32))
        log(f"[{smi}] phase 8c: {preset} {ov} fp32, 2 segments, card vs CPU: "
            f"{enc_msg}; {time.perf_counter() - t0:.1f} s")
        del gpu, cpu


def encoder_card_vs_cpu(gpu, cpu, batch):
    """The encoder output (fp32) of `batch` on the card and on the CPU within
    TOL_MODEL_FP32, the decoder memory within MEMORY_ULPS bf16 ulps (bf16) or
    TOL_MODEL_FP32 (fp32); the two bundles hold the same weights. → the
    printout."""
    import torch
    outs = []
    with torch.no_grad():
        for b in (gpu, cpu):
            enc = b.model.encoder(b.frontend(torch.from_numpy(batch).to(b.device)))
            outs.append((enc.cpu(), b.model.projection(enc).cpu()))
    (enc_g, mem_g), (enc_c, mem_c) = outs
    assert enc_g.dtype == torch.float32 and bool(torch.isfinite(enc_g).all())
    assert mem_g.shape == mem_c.shape and mem_g.dtype == mem_c.dtype
    err_enc = (enc_g - enc_c).abs().max().item()
    a, c = mem_g.float().numpy(), mem_c.float().numpy()
    if mem_g.dtype == torch.bfloat16:
        mag = np.maximum(np.maximum(np.abs(a), np.abs(c)), 1.0)
        ulps = (np.abs(a - c) / 2.0 ** (np.floor(np.log2(mag)) - 7)).max()
        mem_msg = f"memory (bf16) max {ulps:.2f} ulps (tol {MEMORY_ULPS})"
        ok = ulps <= MEMORY_ULPS
    else:
        err_mem = np.abs(a - c).max()
        mem_msg = f"memory (fp32) max|diff| {err_mem:.2e} (tol {TOL_MODEL_FP32})"
        ok = err_mem < TOL_MODEL_FP32
    msg = (f"encoder {tuple(enc_g.shape)} max|diff| {err_enc:.2e} (tol "
           f"{TOL_MODEL_FP32}); {mem_msg}")
    assert err_enc < TOL_MODEL_FP32, msg
    assert ok, msg
    return msg


# ---------------------------------------------------------------------------
# phase 9: data-parallel training and chunk-parallel evaluation
# ---------------------------------------------------------------------------

DDP_STEPS = 5
# 9a: DDP at world 1 against the same steps without a process group: the
# all-reduce of one rank averages over 1, so the losses must be the same
TOL_DDP1_LOSS_REL = 1e-6
# 9b: two gloo ranks on the one card against one process, t5_small width in
# fp32 (TF32 off), dropout DDP2_DROPOUT and SpecAugment (each rank draws the
# global batch's masks and keeps its rows, so the masks are one process's),
# AdamW at 1e-4: the loss is summed in another order; Adam turns a gradient
# at the rounding level into a step of about ±lr, so each weight tensor is
# held by ||w2 - w1|| / ||w1||
TOL_DDP2_LOSS_REL, TOL_DDP2_WEIGHT_REL = 1e-5, 1e-4
DDP2_BATCH, DDP2_STEPS, DDP2_DROPOUT = 8, 2, 0.1
RANK_TIMEOUT_S = 300.0


def flagship_train_steps(tmp, batch, tag):
    """DDP_STEPS of phase 6's run (seed, schedule) on the global `batch`
    through trainer.train inside whatever process group exists; → losses,
    steps/s (over the median step, the first excluded), peak MiB, the fused
    log-mel kernel's launches."""
    import itertools
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.ops import fused_logmel as fl
    from yourmt3_tpu_torch.ops.frontend import SpectrogramFrontend
    from yourmt3_tpu_torch.parallel import mesh
    from yourmt3_tpu_torch.train.trainer import train
    bundle = api.init_model("perceiver_tf_mc13", "mc13_full_plus_256", seed=0)
    bundle.frontend = SpectrogramFrontend.from_config(
        bundle.audio_cfg, use_pallas=True, device=bundle.device)
    steps = StepLog()
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    train(bundle, itertools.repeat(batch), total_steps=DDP_STEPS, log_every=1,
          ckpt_every=0, ckpt_dir=os.path.join(tmp, f"ddp_{tag}"), base_lr=1e-3,
          warmup_steps=2, seed=0, logger=steps, n_data_shards=mesh.world_size())
    torch.cuda.synchronize()
    times = [t for _, t, _ in steps.records]
    out = dict(losses=[m["loss"] for _, _, m in steps.records],
               sps=1.0 / float(np.median(np.diff(times))),
               peak=torch.cuda.max_memory_allocated() / 2**20,
               launches=fl.fused_logmel.launches)
    del bundle
    torch.cuda.empty_cache()
    return out


def ddp_train_path(tmp, trained, smi):
    """Phase 9a: the flagship through trainer.train inside the NCCL group of
    world 1 (DDP's bucketed all-reduce on the card) against the same steps
    without a group."""
    from yourmt3_tpu_torch.parallel import mesh
    assert mesh.data_group() is not None
    ddp = flagship_train_steps(tmp, trained["batch"], "nccl")
    mesh.destroy()
    plain = flagship_train_steps(tmp, trained["batch"], "plain")
    rel = max(abs(a - b) / abs(b) for a, b in zip(ddp["losses"], plain["losses"]))
    log(f"[{smi}] phase 9a: trainer.train(n_data_shards=1) in an NCCL group of "
        f"world 1 (DDP), flagship batch {TRAIN_BATCH}, fused log-mel frontend, "
        f"dropout + SpecAugment, {DDP_STEPS} steps of phase 6's run: losses "
        f"{' '.join(f'{x:.6f}' for x in ddp['losses'])}; without a group "
        f"{' '.join(f'{x:.6f}' for x in plain['losses'])}; max rel diff "
        f"{rel:.3e} (tol {TOL_DDP1_LOSS_REL}); {ddp['sps']:.3f} steps/s (median "
        f"step; without a group {plain['sps']:.3f}, phase 6 "
        f"{trained['steps_per_s']:.3f}); peak {ddp['peak']:.1f} MiB (without "
        f"{plain['peak']:.1f}, phase 6 {trained['peak_mib']:.1f}); fused_logmel "
        f"launches {ddp['launches']}")
    assert ddp["launches"] == DDP_STEPS, ddp["launches"]
    assert rel <= TOL_DDP1_LOSS_REL, rel
    return ddp


def t5_train_steps(batches, ckpt_dir, n_data_shards):
    """DDP2_STEPS of t5_small (fp32, dropout DDP2_DROPOUT, SpecAugment,
    AdamW at 1e-4) through trainer.train; → (metrics by step, weights on the
    CPU)."""
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.train.trainer import train
    bundle = api.init_model("t5_small", "mt3_full_plus", seed=0,
                            compute_dtype="float32", dropout_rate=DDP2_DROPOUT)
    steps = StepLog()
    train(bundle, iter(batches), total_steps=len(batches), log_every=1, ckpt_every=0,
          ckpt_dir=ckpt_dir, base_lr=1e-4, schedule="constant", warmup_steps=1,
          spec_augment=True, seed=0, logger=steps, n_data_shards=n_data_shards)
    return ([m for _, _, m in steps.records],
            {k: v.cpu() for k, v in bundle.model.state_dict().items()})


def _rank_main(rank, world, tmp):
    """One rank of phase 9b: a spawned process in a gloo group, on cuda:0."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = torch.load(os.path.join(tmp, "9b_batches.pt"), weights_only=False)
    metrics, weights = t5_train_steps(batches, os.path.join(tmp, f"9b_{rank}"), world)
    torch.save(dict(metrics=metrics, weights=weights),
               os.path.join(tmp, f"9b_rank{rank}.pt"))


def run_ranks(tmp, world):
    """Spawn `world` ranks of _rank_main on cuda:0 and wait for them (a
    rank that raises, or RANK_TIMEOUT_S, fails the run); → their results
    and the wall time with the processes' start."""
    import torch
    from yourmt3_tpu_torch.parallel import mesh
    t0 = time.perf_counter()
    mesh.spawn_ranks(_rank_main, world, f"file://{tmp}/rendezvous_9b", backend="gloo",
                     device="cuda:0", timeout_s=RANK_TIMEOUT_S, args=(tmp,))
    return ([torch.load(os.path.join(tmp, f"9b_rank{r}.pt")) for r in range(world)],
            time.perf_counter() - t0)


def two_ranks_on_one_card(tmp, smi):
    """Phase 9b: two gloo ranks share the card (NCCL refuses two ranks on
    one GPU) and train t5_small on halves of each global batch; their
    losses and weights against one process on the whole batches."""
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.config.data_presets import get_data_preset
    from yourmt3_tpu_torch.data.dataset_train import TrainDataset
    tm = api.init_model("t5_small", "mt3_full_plus", seed=0).task_manager
    ds = TrainDataset(get_data_preset("synth_smoke").index_files("train"), tm,
                      seed=0)
    batches = [ds.make_batch(DDP2_BATCH) for _ in range(DDP2_STEPS)]
    torch.save(batches, os.path.join(tmp, "9b_batches.pt"))
    ranks, t_ranks = run_ranks(tmp, 2)
    one, w1 = t5_train_steps(batches, os.path.join(tmp, "9b_one"), 1)
    two, w2 = ranks[0]["metrics"], ranks[0]["weights"]
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(two, one))
    rels = {k: ((w2[k] - w1[k]).norm() / w1[k].norm()).item() for k in w1}
    worst_k = max(rels, key=rels.get)
    w_rel = rels[worst_k]
    same = all(torch.equal(ranks[1]["weights"][k], w2[k]) for k in w2)
    tokens = [int((b["labels"] != 0).sum()) for b in batches]
    log(f"[{smi}] phase 9b: 2 gloo ranks on one card, t5_small fp32, dropout "
        f"{DDP2_DROPOUT} + SpecAugment, global batch "
        f"{DDP2_BATCH} ({DDP2_BATCH // 2} per rank, target tokens {tokens}), "
        f"{DDP2_STEPS} steps, {t_ranks:.1f} s with the processes' start: losses "
        f"{[round(m['loss'], 6) for m in two]} vs one process "
        f"{[round(m['loss'], 6) for m in one]}, max rel diff {loss_rel:.3e} (tol "
        f"{TOL_DDP2_LOSS_REL}); grad norms {[round(m['grad_norm'], 5) for m in two]} "
        f"vs {[round(m['grad_norm'], 5) for m in one]}; weights max ||w2 - w1|| / "
        f"||w1|| {w_rel:.3e} (tol {TOL_DDP2_WEIGHT_REL}, {worst_k}; the next "
        f"{sorted(rels.values())[-2]:.3e}); both ranks hold the same weights: {same}")
    assert len(two) == len(one) == DDP2_STEPS
    assert loss_rel <= TOL_DDP2_LOSS_REL and w_rel <= TOL_DDP2_WEIGHT_REL, (loss_rel, w_rel)
    assert same


def chunk_parallel_eval(tmp, smi, evaluated):
    """Phase 9c, inside the NCCL group of world 1: cli.test scores phase 7's
    split chunk-parallel (-b 8 segments per rank: the single path's batch)
    and must write phase 7's JSON; then t5_small's fast path decodes phase
    3a's song through transcribe_song_chunk_parallel and must give the
    single path's notes and errors."""
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.cli import test as cli_test
    from yourmt3_tpu_torch.models import decoding
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia
    from yourmt3_tpu_torch.parallel import mesh
    from yourmt3_tpu_torch.parallel.chunk_stream import transcribe_song_chunk_parallel
    from yourmt3_tpu_torch.train.checkpoint import read_meta
    assert mesh.world_size() == 1 and mesh.data_group() is not None
    ckpt = os.path.join(tmp, "flagship_run", "last")
    layers = read_meta(ckpt)["model"]["num_decoder_layers"]
    out_json = os.path.join(tmp, "eval_mesh.json")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_test.main(["-ckpt", ckpt, "-d", "synth_mc", "--split", "test",
                   "--kv-quant", "int8c4p", "--weight-quant", "int8",
                   "-b", "8", "--output-json", out_json])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, paged = ia.int4_cross_attention.launches, da.paged_decode_attention.launches
    greedy = decoding.greedy_decode.steps
    with open(out_json) as f, open(os.path.join(tmp, "eval.json")) as g:
        same_json = f.read() == g.read()
    log(f"[{smi}] phase 9c: cli.test in an NCCL group of world 1 (chunk-parallel, "
        f"8 segments per rank), perceiver_tf_mc13 int8c4p + int8 weights, phase 6 "
        f"checkpoint, {evaluated['audio_s']:.1f} s of audio: {wall:.2f} s incl. "
        f"load = {evaluated['audio_s'] / wall:.3f} audio-s/s (phase 7, one device: "
        f"{evaluated['wall']:.2f} s = {evaluated['audio_s'] / evaluated['wall']:.3f} "
        f"audio-s/s); greedy steps {greedy}; int4 launches {launches}; paged "
        f"{paged}; metrics JSON identical to phase 7's: {same_json}")
    assert launches == layers * greedy and launches > 0, (launches, greedy)
    assert paged == 0 and same_json

    # the flagship evaluation at unequal shapes: 2 segments per rank
    out_json2 = os.path.join(tmp, "eval_mesh_b2.json")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_test.main(["-ckpt", ckpt, "-d", "synth_mc", "--split", "test",
                   "--kv-quant", "int8c4p", "--weight-quant", "int8",
                   "-b", "2", "--output-json", out_json2])
    torch.cuda.synchronize()
    wall2 = time.perf_counter() - t0
    launches2, greedy2 = ia.int4_cross_attention.launches, decoding.greedy_decode.steps
    with open(out_json2) as f, open(os.path.join(tmp, "eval.json")) as g:
        same_json2 = f.read() == g.read()
    log(f"[{smi}] phase 9c: the same cli.test at 2 segments per rank (phase 7: one "
        f"device, batch 8): {wall2:.2f} s incl. load; greedy steps {greedy2}; int4 "
        f"launches {launches2}; metrics JSON identical to phase 7's: {same_json2} "
        f"(phase 6's checkpoint ends every stream at its second token)")
    assert launches2 == layers * greedy2 and launches2 > 0, (launches2, greedy2)
    assert same_json2

    seconds = 6.0
    song = sine_song(seconds)
    bundle = api.init_model("t5_small", "mt3_full_plus", seed=0,
                            **api.fast_decode_overrides(1, 1024))
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    notes, errs = transcribe_song_chunk_parallel(bundle, song, segments_per_device=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, greedy = da.paged_decode_attention.launches, decoding.greedy_decode.steps
    one, two = chunk_vs_one_device(bundle, song, 2)
    log(f"[{smi}] phase 9c: transcribe_song_chunk_parallel t5_small fast path "
        f"(int8 paged kernel), {seconds} s song, 8 segments per rank, L 1024: "
        f"{wall:.2f} s = {seconds / wall:.3f} audio-s/s (one device through "
        f"transcribe_audio_array: {one['wall']:.2f} s = {seconds / one['wall']:.3f}); "
        f"greedy steps {greedy}; paged launches {launches}; notes {len(notes)}, "
        f"errors {errs.total()}; identical to the one-device path: "
        f"{notes == one['notes'] and errs == one['errors']}")
    assert launches == 8 * greedy and launches > 0, (launches, greedy)
    assert notes == one["notes"] and errs == one["errors"]
    unequal_shapes_report(smi, "t5_small fast path (int8 paged kernel), L 1024",
                          seconds, one, two)
    del bundle
    seconds = 8.0
    bundle = api.init_model("perceiver_tf_mc13", "mc13_full_plus_256", seed=0,
                            **FLAGSHIP)
    one, two = chunk_vs_one_device(bundle, sine_song(seconds), 2)
    unequal_shapes_report(smi, "perceiver_tf_mc13 int8c4p + int8 weights (int4 "
                          "kernel), random weights, L 256", seconds, one, two)
    del bundle


def chunk_vs_one_device(bundle, song, spd):
    """transcribe_audio_array at batch 8 (the one-device path, no repair)
    and transcribe_song_chunk_parallel at `spd` segments per rank on the
    same song, in this process's group; → one dict per path: notes, errors,
    wall, greedy ids (S, C, L) (and the one-device decode's top two logits
    by step, for the margin rule)."""
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.data.audio_io import slice_padded_array
    from yourmt3_tpu_torch.parallel import chunk_stream as cs
    S = slice_padded_array(song, bundle.audio_cfg.input_frames)[0].shape[0]
    rec = Top2Recorder(bundle.model)
    out = {"one": dict(ids=[]), "chunk": dict(ids=[])}
    one_fn, chunk_fn = api.greedy_decode, cs.greedy_decode

    def one_decode(*a, **kw):
        with rec:
            ids = one_fn(*a, **kw)
        out["one"]["ids"].append(ids)
        return ids

    def chunk_decode(*a, **kw):
        ids = chunk_fn(*a, **kw)
        out["chunk"]["ids"].append(ids)
        return ids

    api.greedy_decode, cs.greedy_decode = one_decode, chunk_decode
    try:
        for name, run in (
                ("one", lambda: api.transcribe_audio_array(bundle, song, batch_size=8)),
                ("chunk", lambda: cs.transcribe_song_chunk_parallel(
                    bundle, song, segments_per_device=spd))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            notes, errors = run()
            torch.cuda.synchronize()
            out[name].update(notes=notes, errors=errors, wall=time.perf_counter() - t0,
                             ids=torch.cat(out[name]["ids"])[:S])
    finally:
        api.greedy_decode, cs.greedy_decode = one_fn, chunk_fn
    out["one"]["top2"] = rec.values()
    out["chunk"]["spd"] = spd
    return out["one"], out["chunk"]


def unequal_shapes_report(smi, label, seconds, one, two):
    """Phase 9c at unequal per-rank shapes: chunk-parallel streams against
    the one-device batch of 8; each parted stream printed with the one-device
    decode's top-two margin, held to MARGIN_ULPS as early exit is."""
    same, worst = parting_streams(label, one["ids"], two["ids"], one["top2"],
                                  names=("one device", "chunk-parallel"))
    n = one["ids"].shape[0] * one["ids"].shape[1]
    log(f"[{smi}] phase 9c at unequal shapes: {label}, {seconds} s song, "
        f"{two['spd']} segments per rank vs the one-device batch of 8: {same} of {n} "
        f"streams identical, widest parting margin {worst:.2f} bf16 ulps (limit "
        f"{MARGIN_ULPS}); notes {len(two['notes'])} vs {len(one['notes'])}, "
        f"identical: {two['notes'] == one['notes'] and two['errors'] == one['errors']}; "
        f"{two['wall']:.2f} s vs {one['wall']:.2f} s")
    assert worst <= MARGIN_ULPS, worst
    if same == n:
        assert two["notes"] == one["notes"] and two["errors"] == one["errors"]


def phase9(tmp, smi, trained, evaluated):
    """Phase 9: 9c and 9a in an NCCL group of world 1, then 9b's two gloo
    ranks."""
    import torch
    from yourmt3_tpu_torch.parallel import mesh
    import torch.distributed as dist
    t9 = time.perf_counter()
    mesh.init_data_parallel(0, 1, init_method=f"file://{tmp}/rendezvous_9",
                            device="cuda")
    try:
        t0 = time.perf_counter()
        dist.barrier()  # NCCL builds its communicator at the first collective
        torch.cuda.synchronize()
        log(f"[{smi}] phase 9: NCCL group of world 1 and its communicator set "
            f"up in {time.perf_counter() - t9:.2f} s (the first collective "
            f"{time.perf_counter() - t0:.2f} s)")
        chunk_parallel_eval(tmp, smi, evaluated)
        ddp = ddp_train_path(tmp, trained, smi)  # leaves the group
    finally:
        mesh.destroy()
    torch.cuda.empty_cache()
    two_ranks_on_one_card(tmp, smi)
    log(f"phase 9 took {time.perf_counter() - t9:.1f} s")
    return ddp


# ---------------------------------------------------------------------------
# phase 10: tensor parallel over the model axis, and reference checkpoints
# ---------------------------------------------------------------------------

TP_BATCH = 8
# 10a: (data=1, model=2), the flagship; 10b: (data=2, model=2), the MoE
# flagship; both with dropout and SpecAugment, whose masks every rank draws
# for the global batch and slices (its data rows, its model-axis features),
# so they are one process's
TP_CASES = {
    "10a": dict(preset="perceiver_tf_mc13", layout=(1, 2), steps=3, dropout=0.05,
                spec_augment=True),
    "10b": dict(preset="perceiver_tf_mc13_moe", layout=(2, 2), steps=2, dropout=0.05,
                spec_augment=True),
}
TP_LR = 1e-4
# fp32 (TF32 off) against one process: the sums are split over the ranks
# and all-reduced, so the loss agrees to rounding; the weights are held per
# tensor by ||w_tp - w_1|| / ||w_1||, as in tests/test_torch_tensor_parallel.py:
# the decoder's at TOL_TP_WEIGHT_REL, the encoder's and the projection's
# (their gradient passes back through the bf16 group projection, where
# the partial gradients of the memory sum in another order, so they agree
# to bf16's rounding) at TOL_TP_UPSTREAM_REL, bf16's unit roundoff, over
# their elements outside the rounding band: those whose one-process first
# gradient is nonzero and within TOL_TP_UPSTREAM_REL · rms of zero (the rms
# of its row; of the whole tensor for a vector), where Adam's first step
# (about lr · sign(g)) may turn. At most TP_BAND_MAX of the elements may
# lie in the band.
TOL_TP_LOSS_REL, TOL_TP_WEIGHT_REL, TOL_TP_UPSTREAM_REL = 1e-5, 1e-4, 2.0 ** -9
TP_BAND_MAX = 1e-2
TP_UPSTREAM = ("encoder.", "projection.")


def tp_train(case, batch, group):
    """The steps of a phase-10 case on the global `batch` over the mesh
    `group` (None: one process) on cuda:0: the full-width model in fp32 with
    the fused log-mel frontend, AdamW at TP_LR. → losses, step times, peak
    MiB, fused log-mel launches (in one process also the rounding band of
    the first gradient, see TOL_TP_*), the bundle."""
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.ops import fused_logmel as fl
    from yourmt3_tpu_torch.ops.frontend import SpectrogramFrontend
    from yourmt3_tpu_torch.ops.specaugment import make_augment_fn
    from yourmt3_tpu_torch.parallel import mesh
    from yourmt3_tpu_torch.parallel import tensor_parallel as tpl
    from yourmt3_tpu_torch.train.optim import GradientTransformation, make_optimizer
    from yourmt3_tpu_torch.train.train_step import create_train_state, make_train_step
    c = TP_CASES[case]
    bundle = api.init_model(c["preset"], "mc13_full_plus_256", seed=0,
                            compute_dtype="float32", dropout_rate=c["dropout"])
    bundle.frontend = SpectrogramFrontend.from_config(
        bundle.audio_cfg, use_pallas=True, device=bundle.device)
    if group is not None:
        mesh.shard_params(group, bundle.model)
        batch = mesh.shard_batch(batch, group)
    tx = make_optimizer("adamw", TP_LR, "constant", 1, c["steps"])
    band = {}
    if group is None:
        def update(g, opt_state, params=None, inner=tx.update):
            for k in g if not band else ():
                a = g[k].abs()
                rms = (a.pow(2).mean(-1, keepdim=True) if a.ndim > 1
                       else a.pow(2).mean()).sqrt()
                band[k] = ((a > 0) & (a <= TOL_TP_UPSTREAM_REL * rms)
                           if k.startswith(TP_UPSTREAM) else torch.zeros_like(a, dtype=bool))
            return inner(g, opt_state, params)
        tx = GradientTransformation(tx.init, update)
    step = make_train_step(bundle.model, bundle.frontend, tx, group=group,
                           augment_fn=make_augment_fn() if c["spec_augment"] else None)
    state = create_train_state(bundle.model, tx)
    gen = torch.Generator(device=bundle.device).manual_seed(0)
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], [time.perf_counter()]
    for _ in range(c["steps"]):
        tpl.traffic.update(all_reduce=0, all_gather=0, bytes=0)
        state, metrics = step(state, batch, gen)
        losses.append(float(metrics["loss"]))  # a host read: the step is done
        times.append(time.perf_counter())
    return dict(losses=losses, times=np.diff(times).tolist(),
                peak=torch.cuda.max_memory_allocated() / 2**20,
                launches=fl.fused_logmel.launches, traffic=dict(tpl.traffic),
                band={k: v.cpu() for k, v in band.items()}), bundle


def _tp_rank_main(rank, world, tmp, case):
    """One rank of phase 10a/10b: a spawned process of a gloo group on
    cuda:0. Every rank gathers the weights (the checkpoint too: rank 0
    writes it); each writes its numbers, rank 0 the weights."""
    import torch
    from yourmt3_tpu_torch.parallel import mesh
    from yourmt3_tpu_torch.train.checkpoint import _to_cpu, save_bundle
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = torch.load(os.path.join(tmp, "10_batch.pt"), weights_only=False)
    out, bundle = tp_train(case, batch, mesh.make_mesh(*TP_CASES[case]["layout"]))
    weights = _to_cpu(bundle.model.state_dict())
    save_bundle(os.path.join(tmp, f"{case}_ckpt"), bundle,
                step=TP_CASES[case]["steps"])
    if rank == 0:
        out["weights"] = weights
    out["all_reduce_ms"] = all_reduce_ms(mesh.make_mesh(*TP_CASES[case]["layout"]),
                                         bundle.device)
    torch.save(out, os.path.join(tmp, f"{case}_rank{rank}.pt"))


def all_reduce_ms(m, device, rounds=5):
    """ms of one all-reduce over the model axis of an fp32 activation of the
    flagship's Perceiver-TF blocks at TP_BATCH / n_data rows ((rows·256·26,
    128)), as the step issues it (card → gloo → card), median of `rounds`."""
    import torch
    import torch.distributed as dist
    rows = TP_BATCH // m.size(0)
    x = torch.ones((rows * 256 * 26, 128), device=device)
    group = m.get_group("model")
    out = []
    for _ in range(rounds + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_reduce(x, group=group)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out[1:]))


def tp_weight_errors(got, want, band):
    """Each tensor's relative error over its tolerance (see TOL_TP_*) →
    {group: (worst tensor, its error, its tolerance)} for the groups
    "bias", "upstream" (the encoder's and the projection's other tensors)
    and "other", the number
    of elements in the rounding band and the three tensors with the most."""
    worst = {}
    for k, w in want.items():
        upstream = k.startswith(TP_UPSTREAM)
        tol = TOL_TP_UPSTREAM_REL if upstream else TOL_TP_WEIGHT_REL
        keep = ~band[k] if k in band else torch.ones_like(w, dtype=torch.bool)
        err = ((got[k] - w)[keep].norm() / w[keep].norm()).item() if keep.any() else 0.0
        g = "bias" if k.endswith(".bias") else "upstream" if upstream else "other"
        if g not in worst or err / tol > worst[g][1] / worst[g][2]:
            worst[g] = (k, err, tol)
    counts = {k: int(b.sum()) for k, b in band.items()}
    largest = sorted(counts, key=counts.get, reverse=True)[:3]
    return worst, sum(counts.values()), [(k, counts[k], band[k].numel()) for k in largest]


def tp_case(tmp, smi, case, batch):
    """Phase 10a or 10b: the ranks of the case's layout share the card (gloo:
    NCCL refuses two ranks on one GPU) against one process on the same
    batch and generator seeds."""
    import torch
    from yourmt3_tpu_torch.parallel import mesh
    c = TP_CASES[case]
    n_data, n_model = c["layout"]
    world = n_data * n_model
    torch.save(batch, os.path.join(tmp, "10_batch.pt"))
    t0 = time.perf_counter()
    mesh.spawn_ranks(_tp_rank_main, world, f"file://{tmp}/rendezvous_{case}",
                     backend="gloo", device="cuda:0", timeout_s=RANK_TIMEOUT_S,
                     args=(tmp, case))
    t_ranks = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(tmp, f"{case}_rank{r}.pt")) for r in range(world)]
    one, bundle = tp_train(case, batch, None)
    want = {k: v.detach().cpu() for k, v in bundle.model.state_dict().items()}
    del bundle
    torch.cuda.empty_cache()
    tp = ranks[0]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(tp["losses"], one["losses"]))
    worst, n_band, largest = tp_weight_errors(tp["weights"], want, one["band"])
    n_all = sum(w.numel() for w in want.values())
    weights_msg = "; ".join(f"{g} {k} {err:.3e} (tol {tol:.3e})"
                            for g, (k, err, tol) in sorted(worst.items()))
    launches = [r["launches"] for r in ranks]
    # over the steps after the first (which includes the lazy set-up)
    sps, sps1 = (1.0 / float(np.median(r["times"][1:])) for r in (tp, one))
    log(f"[{smi}] phase {case}: {c['preset']} fp32 on a mesh (data={n_data}, "
        f"model={n_model}) of {world} gloo ranks on one card, global batch {TP_BATCH}, "
        f"{c['steps']} AdamW steps at {TP_LR}, dropout {c['dropout']}, SpecAugment "
        f"{c['spec_augment']}, fused log-mel frontend; {t_ranks:.1f} s with the "
        f"processes' start: losses {[round(x, 6) for x in tp['losses']]} vs one "
        f"process {[round(x, 6) for x in one['losses']]}, max rel diff "
        f"{loss_rel:.3e} (tol {TOL_TP_LOSS_REL}); worst relative weight error: "
        f"{weights_msg}; {n_band} of {n_all} elements in the rounding band (at "
        f"most {TP_BAND_MAX:.0%}; most in {largest}); {sps:.3f} steps/s (one process "
        f"{sps1:.3f}; step s {[round(t, 3) for t in tp['times']]} vs "
        f"{[round(t, 3) for t in one['times']]}); peak MiB per rank "
        f"{[round(r['peak'], 1) for r in ranks]} (one process {one['peak']:.1f}); "
        f"fused_logmel launches per rank {launches}")
    tr = tp["traffic"]
    log(f"[{smi}] phase {case}: rank 0's last step issued {tr['all_reduce']} "
        f"all-reduces and {tr['all_gather']} all-gathers over the model axis, "
        f"{tr['bytes'] / 2**20:.1f} MiB sent into them (the data axis: one "
        f"flattened gradient all-reduce); one all-reduce of a Perceiver-TF "
        f"activation over gloo took {tp['all_reduce_ms']:.2f} ms (median of 5)")
    assert launches == [c["steps"]] * world, launches
    assert one["launches"] == c["steps"], one["launches"]
    assert loss_rel <= TOL_TP_LOSS_REL, loss_rel
    assert all(err <= tol for _, err, tol in worst.values()), worst
    assert n_band <= TP_BAND_MAX * n_all, (n_band, n_all)
    return tp["weights"]


def serve_tp_checkpoint(tmp, smi, gathered):
    """Phase 10c: 10a's checkpoint, written by the sharded ranks, restores
    in this one process with the gathered weights and transcribes phase
    3b's 16 s song through api.transcribe and the int4 kernel."""
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.data.audio_io import write_wav
    from yourmt3_tpu_torch.models import decoding
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia
    from yourmt3_tpu_torch.tokens.midi_io import midi2note
    served = api.load_checkpoint(os.path.join(tmp, "10a_ckpt"), **FLAGSHIP)
    same = all(torch.equal(v.cpu(), gathered[k])
               for k, v in served.model.state_dict().items())
    seconds = 16.0
    wav = os.path.join(tmp, "tp_served.wav")
    write_wav(wav, sine_song(seconds), 16000)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = api.transcribe(served, wav, os.path.join(tmp, "tp_served.mid"), batch_size=8)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, greedy = ia.int4_cross_attention.launches, decoding.greedy_decode.steps
    beam = decoding.beam_decode.steps
    notes = midi2note(out)
    log(f"[{smi}] phase 10c: 10a's sharded checkpoint restored in one process "
        f"(int8c4p K/V, int8 weights): weights equal the gathered shards: {same}; "
        f"{seconds} s song in {wall:.2f} s, decode steps greedy {greedy} + beam "
        f"{beam}; int4 kernel launches {launches}; notes {len(notes)}")
    layers = served.cfg.num_decoder_layers
    assert same and launches == layers * (greedy + beam) and launches > 0, (
        same, launches, greedy, beam)


def reference_import(tmp, smi):
    """Phase 10d: a reference-style .ckpt written from a seeded full-width
    flagship on the card (import_reference.reference_style_state_dict, the
    experts per expert) loads through import_checkpoint(require_complete=True)
    into a model of another seed; its logits must equal the source's."""
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.models.ymt3 import shift_right
    from yourmt3_tpu_torch.train import import_reference
    src = api.init_model("perceiver_tf_mc13_moe", "mc13_full_plus_256", seed=0)
    path = os.path.join(tmp, "reference.ckpt")
    sd = import_reference.reference_style_state_dict(src.model, per_expert=True)
    torch.save({"state_dict": sd, "epoch": 0}, path)
    dst = api.init_model("perceiver_tf_mc13_moe", "mc13_full_plus_256", seed=1)
    t0 = time.perf_counter()
    import_reference.import_checkpoint(path, dst.model, verbose=False,
                                       require_complete=True)
    t_import = time.perf_counter() - t0
    n = src.audio_cfg.input_frames
    audio = torch.from_numpy(sine_song(4 * n / 16000 + 0.1)[:4 * n].reshape(4, n)).to(
        src.device)
    labels = torch.randint(3, src.cfg.vocab_size, (4, src.cfg.num_channels, 64),
                           generator=torch.Generator().manual_seed(0)).to(src.device)
    with torch.no_grad():
        want = src.model(src.frontend(audio), shift_right(labels))
        got = dst.model(dst.frontend(audio), shift_right(labels))
    equal = torch.equal(got, want)
    log(f"[{smi}] phase 10d: perceiver_tf_mc13_moe (full width) → a reference-style "
        f".ckpt of {len(sd)} tensors (experts unstacked, "
        f"{os.path.getsize(path) / 2**20:.1f} MiB) → import_checkpoint("
        f"require_complete=True) into a model of another seed in {t_import:.2f} s: "
        f"logits {tuple(got.shape)} equal the source's: {equal} (max |diff| "
        f"{(got - want).abs().max().item():.3e})")
    assert equal


def phase10(tmp, smi, trained):
    """Phase 10: 10a and 10b (spawned ranks sharing the card), 10c on 10a's
    checkpoint, 10d."""
    t10 = time.perf_counter()
    batch = {k: v[:TP_BATCH] for k, v in trained["batch"].items()}
    gathered = tp_case(tmp, smi, "10a", batch)
    serve_tp_checkpoint(tmp, smi, gathered)
    tp_case(tmp, smi, "10b", batch)
    reference_import(tmp, smi)
    log(f"phase 10 took {time.perf_counter() - t10:.1f} s")


# ---------------------------------------------------------------------------
# phase 11: the grouped-query flagships
# ---------------------------------------------------------------------------

GROUPED = ("perceiver_tf_mc13_mqa", "perceiver_tf_mc13_gqa2")
# the other caches JAX allows with grouped K/V, each decoded on the card
# for GROUPED_MODE_STEPS steps of the same memory, and beam 2 as long
GROUPED_MODES = ("none", "int8c4", "int4")
GROUPED_MODE_STEPS = 64


def grouped_flagship(preset, smi):
    """Phase 11 for one grouped-query flagship at full width in fp32, random
    weights from seed 0, on 2 segments of the 16 s song (L = 256): served on
    the card through transcribe_segments_array with the fast decode settings
    of a 13-channel decode (dense int8 self cache) and the beam-2 repair;
    its encoder and memory against the CPU's (phase 8c's limits); the
    card's memory decoded on the CPU, whose greedy tokens the card's may
    leave only at near-ties (MARGIN_ULPS); then the other caches and beam 2
    on the card. The grouped caches are dense: the dense int8 kernel serves
    the self- and cross-attention, each KV head's G query rows together,
    and no other kernel may launch."""
    import torch
    from yourmt3_tpu_torch import api
    from yourmt3_tpu_torch.data.audio_io import slice_padded_array
    from yourmt3_tpu_torch.models import decoding
    from yourmt3_tpu_torch.models.ymt3 import YMT3
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia
    from yourmt3_tpu_torch.ops import kv_quant as kq
    t_all = time.perf_counter()
    task, over = "mc13_full_plus_256", api.fast_decode_overrides(13, 256)
    assert over == {"kv_quant": "int8"}, over
    kw = dict(seed=0, compute_dtype="float32", **over)
    gpu = api.init_model(preset, task, **kw)
    cpu = api.init_model(preset, task, device="cpu", **kw)
    ac, tm = gpu.audio_cfg, gpu.task_manager
    L, prefix = tm.max_token_length, tm.subtask_prefix_ids()
    segs, starts = slice_padded_array(sine_song(16.0), ac.input_frames)
    segs = np.ascontiguousarray(segs[:2], np.float32)
    starts = (starts[:2] / ac.sample_rate).tolist()
    audio_s = 2 * ac.input_frames / ac.sample_rate

    # served on the card, the greedy pass's memory and ids kept (the repair
    # encodes the segments it re-decodes once more)
    kept = {}
    encode_fn, greedy_fn = api._encode_batch, api.greedy_decode

    def encode(bundle, audio):
        memory = encode_fn(bundle, audio)
        kept.setdefault("memory", memory)
        return memory

    def greedy(*a, **kw):
        ids = greedy_fn(*a, **kw)
        kept.setdefault("ids", ids)
        return ids

    api._encode_batch, api.greedy_decode = encode, greedy
    try:
        reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        notes, errs = api.transcribe_segments_array(gpu, segs, starts, batch_size=2,
                                                    repair_beam=2)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        api._encode_batch, api.greedy_decode = encode_fn, greedy_fn
    peak = torch.cuda.max_memory_allocated() / 2**20
    greedy_steps, beam_steps = decoding.greedy_decode.steps, decoding.beam_decode.steps
    kernels = (da.paged_decode_attention.launches, ia.int4_cross_attention.launches)
    int8 = kq.int8_decode_attention.launches
    enc_msg = encoder_card_vs_cpu(gpu, cpu, segs)

    # the card's memory decoded on the CPU: the card's tokens against it
    memory = kept["memory"]
    rec = Top2Recorder(cpu.model)
    with torch.no_grad(), rec:
        cpu_ids = greedy_fn(cpu.model, memory.cpu(), L, prefix_ids=prefix,
                            cross_kvs=cpu.model.init_cross_kv(memory.cpu()))
    same, worst = parting_streams(f"{preset} int8", cpu_ids, kept["ids"], rec.values(),
                                  names=("CPU", "card"))
    n = cpu_ids.shape[0] * cpu_ids.shape[1]

    # the other caches and beam 2, on the card, from the same memory
    n_steps = GROUPED_MODE_STEPS
    served = kept["ids"][..., :n_steps]
    modes = []
    with torch.no_grad():
        for mode in GROUPED_MODES:
            model = YMT3(gpu.cfg.replace(kv_quant=mode), ac.num_feature_bins).to(
                gpu.device)
            model.load_state_dict(gpu.model.state_dict(), strict=True)
            ids = greedy_fn(model.eval(), memory, n_steps, prefix_ids=prefix)
            assert ids.shape == served.shape and int(ids.min()) >= 0
            assert int(ids.max()) < gpu.cfg.vocab_size
            modes.append(f"{mode} {(ids == served).float().mean().item():.1%}")
            del model
        beam = decoding.beam_decode(gpu.model, memory, n_steps, beam_size=2,
                                    prefix_ids=prefix)
    assert beam.shape == served.shape and int(beam.max()) < gpu.cfg.vocab_size
    kernels_after = (da.paged_decode_attention.launches, ia.int4_cross_attention.launches)
    log(f"[{smi}] phase 11: {preset} (decoder_kv_heads {gpu.cfg.decoder_kv_heads} of "
        f"{gpu.cfg.num_heads}) full width fp32, random weights (seed 0), 2 segments "
        f"of the 16 s song, L {L}, served through transcribe_segments_array with "
        f"{over} and the beam-2 repair (smoke numbers, not a benchmark): "
        f"{wall:.2f} s = {audio_s / wall:.3f} audio-s/s, peak {peak:.1f} MiB; decode "
        f"steps greedy {greedy_steps} + beam {beam_steps}; notes {len(notes)}, errors "
        f"{errs.total()}; paged / int4 kernel launches {kernels} (dense caches), "
        f"dense int8 kernel launches {int8} (self and cross); "
        f"card vs CPU: {enc_msg}; greedy tokens from the card's memory: {same} of "
        f"{n} streams identical to the CPU's, widest parting margin {worst:.2f} bf16 "
        f"ulps (limit {MARGIN_ULPS}); the first {n_steps} tokens of the served int8 "
        f"decode equal under {', '.join(modes)}; beam 2 ({n_steps} steps) "
        f"{(beam == served).float().mean().item():.1%}; kernel launches after "
        f"them {kernels_after}; {time.perf_counter() - t_all:.1f} s")
    assert greedy_steps > 0 and kernels == kernels_after == (0, 0), kernels_after
    layers = gpu.cfg.num_decoder_layers
    assert int8 == 2 * layers * (greedy_steps + beam_steps), (int8, greedy_steps, beam_steps)
    assert worst <= MARGIN_ULPS, worst


def phase11(smi):
    """Phase 11: the two grouped-query flagships."""
    t11 = time.perf_counter()
    for preset in GROUPED:
        grouped_flagship(preset, smi)
    log(f"phase 11 took {time.perf_counter() - t11:.1f} s")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernels-only", action="store_true",
                   help="stop after building and checking the kernels")
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from yourmt3_tpu_torch.ops import cuda_build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    t0 = time.perf_counter()
    cuda_build.load()
    log(f"built {list(cuda_build.KERNELS)} and the {cuda_build.BINDING} binding "
        f"with nvcc into {os.path.relpath(cuda_build.LIBRARY)} and loaded it in "
        f"{time.perf_counter() - t0:.1f} s")

    worst = check_kernel(dev)
    worst4 = check_int4(dev)
    worst8 = check_int8(dev)
    worst_mel = check_logmel(dev)
    rows = time_kernel(dev)
    rows4 = time_int4(dev)
    rows8 = time_int8(dev)
    rows_mel = time_logmel(dev)
    probe = probe_path(dev)
    wrapper_host_us(dev)
    if args.kernels_only:
        return 0
    from yourmt3_tpu_torch import api
    with tempfile.TemporaryDirectory() as tmp:
        launches = main_path(tmp)
        launches4, launches8 = flagship_path(tmp)
        trained = train_path(tmp)
        evaluated = eval_path(tmp, dev, smi)
        t8 = time.perf_counter()
        moe_flagship_path(tmp, smi)
        conformer_path(tmp, smi)
        t8 = time.perf_counter() - t8
        phase9(tmp, smi, trained, evaluated)
        phase10(tmp, smi, trained)
    t8c = time.perf_counter()
    options_card_vs_cpu(smi)
    log(f"phase 8 took {t8 + time.perf_counter() - t8c:.1f} s")
    phase11(smi)
    kernel_in_model()
    flagship_in_model()
    where_time_goes("t5_small", api.init_model(
        "t5_small", "mt3_full_plus", seed=0,
        **api.fast_decode_overrides(1, 1024)), sine_song(), 496,
        "paged_decode")  # the split kernel and its merge kernel
    where_time_goes("perceiver_tf_mc13", api.init_model(
        "perceiver_tf_mc13", "mc13_full_plus_256", seed=0, **FLAGSHIP),
        sine_song(16.0), 112, "int4_cross_kernel")

    r, r4, rm = rows[8, 1023], rows4[104], rows_mel[TRAIN_BATCH]
    r8 = rows8["self", 104, 255]
    kernels = [{
        "name": "paged_decode_attention", "route": "cuda",
        "source": "yourmt3_tpu_torch/ops/csrc/paged_decode_attention.cu",
        "replaces": "yourmt3_tpu/ops/pallas/decode_attention.py:137",
        "launches": launches, "max_abs_err": worst["bf16"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    }, {
        "name": "int4_cross_attention", "route": "cuda",
        "source": "yourmt3_tpu_torch/ops/csrc/int4_cross_attention.cu",
        "replaces": "yourmt3_tpu/ops/pallas/decode_attention.py:441",
        "launches": launches4, "max_abs_err": worst4["bf16"],
        "ms": r4["ms"], "plain_ms": r4["plain_ms"], "bound_ms": r4["bound_ms"],
        "bound_by": r4["bound_by"], "library_ms": r4["library_ms"],
    }, {
        "name": "int8_decode_attention", "route": "cuda",
        "source": "yourmt3_tpu_torch/ops/csrc/int8_decode_attention.cu",
        "replaces": "none (yourmt3_tpu/ops/kv_quant.py int8_decode_attention, jnp)",
        "launches": launches8, "max_abs_err": worst8["bf16"],
        "ms": r8["ms"], "plain_ms": r8["plain_ms"], "bound_ms": r8["bound_ms"],
        "bound_by": r8["bound_by"], "library_ms": r8["library_ms"],
    }, {
        "name": "fused_logmel", "route": "cuda",
        "source": "yourmt3_tpu_torch/ops/csrc/fused_logmel.cu",
        "replaces": "yourmt3_tpu/ops/pallas/frontend_kernel.py:66",
        "launches": trained["launches"], "max_abs_err": worst_mel,
        "ms": rm["ms"], "plain_ms": rm["plain_ms"], "bound_ms": rm["bound_ms"],
        "bound_by": rm["bound_by"], "library_ms": rm["library_ms"],
    }, {
        "name": "launch_probe", "route": "cuda",
        "source": "yourmt3_tpu_torch/ops/csrc/launch_probe.cu",
        "replaces": "scripts/bench_kernels.py:61",
        "launches": probe["launches"], "max_abs_err": 0.0,
        "ms": probe["ms"], "plain_ms": probe["plain_ms"],
        "bound_ms": probe["bound_ms"], "bound_by": probe["bound_by"],
        "library_ms": probe["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
