"""The operation and byte counts against hand counts at a tiny shape."""

import pytest

from counts import flops

AUDIO = {"input_frames": 8 * 4 - 1, "hop_length": 4, "n_mels": 16,  # T = 8
         "codec": "melspec", "n_fft": 16}
CFG = {"conv_channels": 2, "ptf_d_latent": 4, "ptf_num_latents": 2,
       "ptf_num_blocks": 1, "ptf_num_moe_experts": 0, "ptf_moe_topk": 2,
       "d_model": 6, "num_heads": 1, "d_kv": 3, "d_ff": 5,
       "num_decoder_layers": 1, "vocab_size": 7, "num_channels": 2,
       "max_target_length": 2}


def config(cfg=CFG, audio=AUDIO):
    return {"encoder": "perceiver_tf", "model": cfg, "audio": audio}


def test_frames_and_bins():
    assert flops.frames(AUDIO) == 8
    assert flops.feature_bins(AUDIO) == 16
    assert flops.feature_bins(dict(AUDIO, codec="spec")) == 9


def test_odd_bins_round_up_as_same_padding_does():
    """9 spectrogram bins → 5, 3, 2 tokens, as 16 mels → 8, 4, 2: the same
    count but for the two first blocks' convolutions."""
    T, C = 8, 2
    more = 2 * 9 * T * ((5 - 8) * C * (1 + 2 * C) + (3 - 4) * C * 3 * C)
    spec = config(audio=dict(AUDIO, codec="spec"))
    assert flops.encoder_forward(spec, 1) - flops.encoder_forward(config(), 1) == more


def test_encoder_by_hand():
    T, C, D, K = 8, 2, 4, 2
    conv = 2 * 9 * T * (8 * C * (1 + 2 * C) + 4 * C * 3 * C + 2 * C * 3 * C)
    spec = 2 * T * 2 * C * D  # F' = 2 tokens of C channels → D
    sca = T * (2 * 2 * K * D * D + 2 * 2 * 2 * D * D + 2 * 2 * K * 2 * D
               + K * 2 * 2 * D * 4 * D)
    blk = lambda n, length: n * (8 * length * D * D + 4 * length * length * D  # noqa: E731
                                 + length * 16 * D * D)
    proj = 2 * T * K * D * 6
    assert flops.encoder_forward(config(), 3) == 3 * (conv + spec + sca + blk(K, T)
                                                        + blk(T, K) + proj)


def test_moe_counts_routed_experts_only():
    moe = dict(CFG, ptf_num_moe_experts=8, ptf_moe_topk=2)
    dense = flops.encoder_forward(config(), 1)
    T, K, D = 8, 2, 4
    per_token = 2 * 16 * D * D + 2 * D * 8 - 16 * D * D  # two experts + router - one FF
    assert flops.encoder_forward(config(moe), 1) - dense == 2 * K * T * per_token


def test_decoder_by_hand():
    inner, dm, T = 3, 6, 8
    pos = lambda seen: (8 * dm * inner + 4 * inner * seen + 4 * dm * inner  # noqa: E731
                        + 4 * inner * T + 6 * dm * 5) + 2 * dm * 7
    cross = 4 * T * dm * inner
    assert flops.decode(CFG, AUDIO, 5, 2) == 5 * (cross + pos(1) + pos(2))
    assert flops.train_step(config(), 3) == 3 * (
        flops.encoder_forward(config(), 3) + flops.decode(CFG, AUDIO, 6, 2))


def test_int4_call_bytes_and_operations():
    nbytes, ops = flops.int4_cross_call(streams=2, heads=3, dk=4, T=5)
    assert nbytes == 2 * 2 * 3 * 4 * 2 + 2 * 2 * 3 * 2 * 5 + 2 * 2 * 3 * 5 * 4
    assert ops == 4 * 2 * 3 * 5 * 4
    assert flops.least_time(3.35e12, 0) == pytest.approx(1.0)
    assert flops.least_time(0, 67e12) == pytest.approx(1.0)


def test_trace_busy_is_the_union_and_gaps_go_to_the_open_span():
    from harness.core import Span
    from harness.trace import summarize
    events = [("a", 10, 30), ("b", 20, 40), ("a", 60, 70), ("c", 95, 120)]
    spans = [Span("outer", 0, 100), Span("inner", 40, 60)]
    s = summarize(events, 0, 100, spans)
    assert s.busy_s == pytest.approx(45e-9)  # [10, 40] + [60, 70] + [95, 100]
    assert s.window_s == pytest.approx(100e-9)
    assert s.by_name["a"] == (2, pytest.approx(30e-9))
    assert s.kernel_seconds(("a", "b")) == (3, pytest.approx(50e-9))
    assert s.gaps_by_span == {"outer": pytest.approx(35e-9), "inner": pytest.approx(20e-9)}
    assert s.breakdown()["device_ops"][0][0] == "a"


def test_t5_encoder_by_hand():
    cfg = dict(CFG, num_heads=2, d_kv=3, num_encoder_layers=2)
    T, f, dm, inner, dff = 8, 16, 6, 6, 5
    per_frame = 2 * f * dm + 2 * (8 * dm * inner + 4 * T * inner + 6 * dm * dff)
    t5 = {"encoder": "t5", "model": cfg, "audio": AUDIO}
    assert flops.encoder_forward(t5, 3) == 3 * T * per_frame


def test_paged_decode_call_bytes_and_operations():
    nbytes, ops = flops.paged_decode_call(streams=2, heads=3, dk=4, live=5)
    qo = 2 * 2 * 3 * 4 * 2  # bf16 q and out
    kv = 2 * 2 * 3 * 5 * 4  # int8 K and V
    scales = 2 * 2 * 3 * 5 * 4  # their fp32 row scales
    assert nbytes == qo + kv + scales
    assert ops == 4 * 2 * 3 * 5 * 4


def test_paged_roofline_sums_every_step_and_layer():
    import types
    from harness.trace import Summary
    from harness.core import reader
    read = reader("paged_decode_roofline")
    cfg = {"num_heads": 3, "d_kv": 4, "num_decoder_layers": 2}
    calls = [{"traced": True, "rows": 2, "channels": 1, "beam": 1, "steps": 3},
             {"traced": True, "rows": 2, "channels": 1, "beam": 2, "steps": 2},
             {"traced": False, "rows": 2, "channels": 1, "beam": 1, "steps": 9}]
    least = sum(2 * flops.least_time(*flops.paged_decode_call(s, 3, 4, p + 1))
                for s, n in ((2, 3), (4, 2)) for p in range(n))
    trace = Summary(1.0, 0.5, {"void paged_decode_kernel<bf16>": (10, 2 * least),
                               "void paged_decode_merge_kernel<bf16>": (0, 2 * least),
                               "int4_cross_kernel": (5, 1.0)}, {})
    run = types.SimpleNamespace(trace=trace, calls=calls,
                                cell=types.SimpleNamespace(config={"model": cfg}))
    assert read(run) == pytest.approx(25.0)
    run.trace = Summary(1.0, 0.5, {"int4_cross_kernel": (5, 1.0)}, {})
    assert read(run) is None  # no paged kernel traced: nothing to read
