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
     and its bound. The paged kernel is timed at pos 127, 511 and 1023
     with its split count; the fused log-mel kernel is held at B in
     {1, 8, 16}; the
     launch probe's own path is its launch-overhead measurement (eager
     through its operator in turns with torch's x + 1, then each inside
     one CUDA graph);
     then each wrapper's eager host µs per call beside torch's x + 1;
  3. the two main paths, each with every launch count set to 0 just
     before it and read just after:
     a. t5_small: the CLI transcribes a seeded ~6 s sine-mixture WAV at
        full width (random weights from a seed) through --decode-path
        fast with the beam-2 repair; the paged kernel's launches must
        equal 8 (decoder layers) x the decode steps run;
     b. the flagship perceiver_tf_mc13 (kv_quant="int8c4p", int8 decoder
        weights): api.init_model + api.transcribe on a seeded 16 s song
        (8 segments, one batch, 104 decoder streams) with the beam-2
        repair; the int4 cross kernel's launches must equal 8 x the
        decode steps run, and the paged kernel must not launch;
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
     cli.train at t5_small width.

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
                    got = da.paged_decode_attention(qq, pages["k"], pages["v"],
                                                    pos, **kw)
                    plain_kw = {k: v for k, v in kw.items() if k != "dist_buckets"}
                    want = da.paged_decode_attention_plain(
                        qq, pages["k"], pages["v"], pos, **plain_kw)
                    assert got.dtype == qdt and got.shape == (S, H, DK)
                    assert bool(torch.isfinite(got).all())
                    err = (got.float() - want.float()).abs().max().item()
                    errs[qt] = max(errs[qt], err)
            torch.cuda.synchronize()
            log(f"kernel check S={S} {name:10s} pos={list(positions)}: max|err| "
                f"fp32 q {errs['fp32']:.3e} (tol {TOL_FP32}), bf16 q "
                f"{errs['bf16']:.3e} (tol {TOL_BF16})")
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


def time_kernel(dev):
    """Times at the main path's shape: S = 8, int8 pages, table bias, a
    decoder's 8 layer caches cycled (53 MB, about the size of L2), the
    kernel with the split count it picks."""
    import torch
    import torch.nn.functional as F
    from yourmt3_tpu_torch.models.layers import relative_position_bucket
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops.kv_quant import dequantize_kv
    gen = torch.Generator().manual_seed(1)
    S, layers = 8, 8
    table = (torch.randn(BUCKETS, H, generator=gen) * 0.5).to(dev)
    dist = da.distance_buckets(BUCKETS, MAXD).to(dev)
    q = torch.randn(S, H, DK, generator=gen).to(dev).to(torch.bfloat16)
    caches = [make_pages(S, True, gen, dev) for _ in range(layers)]

    def dense(c, n):  # (NB,S,H,block,dk) int8 + (S,NB,H,block) → (S,H,L,dk)
        vals = c[n].permute(1, 2, 0, 3, 4).reshape(S, H, L, DK)
        sc = c[n + "s"].permute(0, 2, 1, 3).reshape(S, H, L)
        return dequantize_kv(vals, sc).to(torch.bfloat16)

    dense_kv = [(dense(c, "k"), dense(c, "v")) for c in caches]
    rows = {}
    for pos in (127, 511, 1023):
        kw = dict(rel_table=table, dist_buckets=dist)
        j = torch.arange(L, device=dev, dtype=torch.int32)
        bias = table[relative_position_bucket(j - pos, False, BUCKETS, MAXD).long()].T
        mask = torch.where(j <= pos, bias, torch.full_like(bias, float("-inf")))
        mask = mask[None, :, None, :].to(torch.bfloat16)  # (1, H, 1, L)
        q4 = q[:, :, None, :]

        def kernel():
            for c in caches:
                da.paged_decode_attention(q, c["k"], c["v"], pos, k_scale=c["ks"],
                                          v_scale=c["vs"], **kw)

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
        splits, split_rows = da.decode_splits(S, H, pos)
        rows[pos] = dict(ms=graph_ms(kernel, layers), plain_ms=graph_ms(plain, layers),
                         library_ms=graph_ms(library, layers),
                         bound_ms=b_ms, bound_by=b_by)
        r = rows[pos]
        log(f"time S={S} int8+table pos={pos} ({splits} ranges of {split_rows} "
            f"rows, {S * H * splits} CTAs): kernel {r['ms'] * 1e3:.2f} us, plain "
            f"{r['plain_ms'] * 1e3:.2f} us, library (SDPA, dense bf16) "
            f"{r['library_ms'] * 1e3:.2f} us, bound ({b_by}) {b_ms * 1e3:.2f} us")
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
    """The fused log-mel kernel against its plain version at full width
    (32767 samples → 256 frames × 512 mels), B in {1, 8, 16}."""
    import torch
    from yourmt3_tpu_torch.ops import fused_logmel as fl
    fe = logmel_frontend(dev)
    worst = 0.0
    for B in LOGMEL_BATCHES:
        audio = logmel_audio(B, dev)
        got = fe(audio)
        want = fl.fused_logmel_plain(audio, fe.basis_cos, fe.basis_sin,
                                     fe.mel_fb, fe.cfg)
        torch.cuda.synchronize()
        assert got.shape == (B, 256, 512) and bool(torch.isfinite(got).all())
        err = (got - want).abs().max().item()
        log(f"fused_logmel check B={B} (frames per thread "
            f"{fl.frames_per_thread(B, 256, torch.cuda.get_device_properties(dev).multi_processor_count)}): "
            f"max|err| {err:.3e} (tol {TOL_LOGMEL})")
        assert err <= TOL_LOGMEL, (B, err)
        worst = max(worst, err)
    return worst


def bound_logmel(B, cfg):
    """(ms, "bytes" or "operations"): the DFT (cos and sin) and mel
    products' fp32 multiply-adds; the audio, both bases, the filterbank
    and the output each moved once."""
    n_bins, T = cfg.n_fft // 2 + 1, cfg.num_frames
    ops = B * (2 * 2 * T * cfg.n_fft * n_bins + 2 * T * n_bins * cfg.n_mels)
    nbytes = 4 * (B * cfg.input_frames + 2 * cfg.n_fft * n_bins
                  + n_bins * cfg.n_mels + B * T * cfg.n_mels)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_logmel(dev):
    """Kernel, plain version and the cuFFT route (torch.stft with a
    periodic Hann window, center=True, reflect; abs; mel product; log:
    four calls, not one), each with CUDA events over 10 eager calls, at
    B = 16 (training) and 8 (serving)."""
    import torch
    from yourmt3_tpu_torch.ops import fused_logmel as fl
    fe = logmel_frontend(dev)
    cfg = fe.cfg
    packed = fl.pack_bases(fe.basis_cos, fe.basis_sin, fe.mel_fb)
    win = torch.hann_window(cfg.n_fft, periodic=True, device=dev)
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
        b_ms, b_by = bound_logmel(B, cfg)
        rows[B] = dict(ms=events_ms(lambda: fl.fused_logmel(*args, packed=packed), 10),
                       plain_ms=events_ms(lambda: fl.fused_logmel_plain(*args), 10),
                       library_ms=events_ms(library, 10), bound_ms=b_ms,
                       bound_by=b_by)
        r = rows[B]
        log(f"time fused_logmel B={B}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library (cuFFT route: stft, abs, mel "
            f"matmul, log) {r['library_ms']:.4f} ms (max|diff| to the kernel "
            f"{lib_err:.2e}), bound ({b_by}, fp32 {FP32_FLOPS / 1e12:.0f} "
            f"TFLOP/s outside the tensor cores) {b_ms:.4f} ms = "
            f"{b_ms / r['ms']:.1%} of the kernel's time")
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
    greedy, beam = decoding.greedy_decode.steps, decoding.beam_decode.steps
    assert len(outs) == 1 and os.path.exists(outs[0]), outs
    notes = midi2note(outs[0])
    log(f"main path: t5_small fast decode, {seconds} s audio in {wall:.2f} s "
        f"(CLI wall incl. init) = {seconds / wall:.3f} audio-s/s; decode "
        f"steps greedy {greedy} + beam {beam}; kernel launches {launches}; "
        f"notes {len(notes)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    assert launches == 8 * (greedy + beam) and launches > 0, (launches, greedy, beam)
    assert int4_launches == 0, int4_launches
    return launches


def reset_counts():
    """Every kernel's launch count and the decode step counts to 0."""
    from yourmt3_tpu_torch.models import decoding
    from yourmt3_tpu_torch.ops import decode_attention as da
    from yourmt3_tpu_torch.ops import fused_logmel as fl
    from yourmt3_tpu_torch.ops import int4_cross_attention as ia
    from yourmt3_tpu_torch.ops import launch_probe as lp
    da.paged_decode_attention.launches = 0
    ia.int4_cross_attention.launches = 0
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
    greedy, beam = decoding.greedy_decode.steps, decoding.beam_decode.steps
    assert os.path.exists(out), out
    notes = midi2note(out)
    log(f"main path: perceiver_tf_mc13 int8c4p + int8 weights, {seconds} s audio "
        f"(8 segments, 104 streams) in {wall:.2f} s (init {t_init:.2f} s + "
        f"transcribe {wall - t_init:.2f} s) = {seconds / wall:.3f} audio-s/s "
        f"({seconds / (wall - t_init):.3f} without init); decode steps greedy "
        f"{greedy} + beam {beam}; int4 kernel launches {launches}; paged "
        f"kernel launches {paged}; notes {len(notes)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    layers = bundle.cfg.num_decoder_layers
    assert launches == layers * (greedy + beam) and launches > 0, (launches, greedy, beam)
    assert paged == 0, paged
    return launches


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

        cross = model.init_cross_kv(mem)
        S = mem.shape[0] * mem.shape[1]
        kv = model.empty_self_kvs(S, tm_len)
        tok = torch.zeros((S, 1), dtype=torch.long, device=mem.device)
        n = 32

        def window():
            nonlocal kv
            for pos in range(first, first + n):
                logits, kv = model.decode_step(tok, pos, kv, cross)
                tok.copy_(logits.argmax(-1, keepdim=True))

        window()  # warm-up
        _, wall = timed(window)
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
                        programs=(0, 24, 32, 40, 56, 73), seed=0,
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
    others = (da.paged_decode_attention.launches, ia.int4_cross_attention.launches)
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
    assert others == (0, 0), others
    assert all(np.isfinite(losses)) and all(np.isfinite(gnorms))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    assert not torch.equal(bundle.model.lm_head.weight, head0)

    serve_from_checkpoint(tmp, os.path.join(ckpt_dir, "last"), bundle)
    profile_train_steps(bundle, batch)
    del bundle
    torch.cuda.empty_cache()
    cli_train_steps(tmp)
    return dict(launches=launches, steps_per_s=sps, tokens_per_s=sps * tokens,
                peak_mib=peak, loss_first=losses[0], loss_last=losses[-1])


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
    """Two steps of `cli.train` at t5_small width on the smoke synth set."""
    from yourmt3_tpu_torch.cli import train as cli_train
    from yourmt3_tpu_torch.train.checkpoint import restore_opt_state
    t0 = time.perf_counter()
    run = cli_train.main(["smoke", "-d", "synth_smoke", "-m", "t5_small",
                          "-b", "16", "-s", "2", "--warmup-steps", "1",
                          "--log-every", "1", "--ckpt-every", "2",
                          "--num-workers", "1",
                          "--ckpt-dir", os.path.join(tmp, "cli_run")])
    wall = time.perf_counter() - t0
    with open(os.path.join(run, "smoke_log.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    log(f"cli.train t5_small, batch 16, 2 steps in {wall:.2f} s (incl. init "
        f"and data): losses {[round(r['loss'], 4) for r in recs]}")
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert restore_opt_state(os.path.join(run, "last"))["step"] == 2


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
    worst_mel = check_logmel(dev)
    rows = time_kernel(dev)
    rows4 = time_int4(dev)
    rows_mel = time_logmel(dev)
    probe = probe_path(dev)
    wrapper_host_us(dev)
    if args.kernels_only:
        return 0
    from yourmt3_tpu_torch import api
    with tempfile.TemporaryDirectory() as tmp:
        launches = main_path(tmp)
        launches4 = flagship_path(tmp)
        trained = train_path(tmp)
    kernel_in_model()
    flagship_in_model()
    where_time_goes("t5_small", api.init_model(
        "t5_small", "mt3_full_plus", seed=0,
        **api.fast_decode_overrides(1, 1024)), sine_song(), 496,
        "paged_decode")  # the split kernel and its merge kernel
    where_time_goes("perceiver_tf_mc13", api.init_model(
        "perceiver_tf_mc13", "mc13_full_plus_256", seed=0, **FLAGSHIP),
        sine_song(16.0), 112, "int4_cross_kernel")

    r, r4, rm = rows[1023], rows4[104], rows_mel[TRAIN_BATCH]
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
