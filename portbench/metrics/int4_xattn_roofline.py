"""The int4 cross-attention kernel's share of its roofline: over every
decode call of the traced songs, the least time (bytes over HBM bandwidth or
fp32 operations over the fp32 peak, counts/flops.py, at each call's own
shape: 8 calls per decode step, one per decoder layer, over the padded
rows' streams and beams) over the device time of the kernels named here,
in %."""

from counts import flops

KERNELS = ("int4_cross_kernel",)


def read(run):
    if run.trace is None:
        return None
    launches, seconds = run.trace.kernel_seconds(KERNELS)
    if not launches or seconds <= 0:
        return None
    cfg, audio = run.cell.config["model"], run.cell.config["audio"]
    least = 0.0
    for c in (c for c in run.calls if c["traced"]):
        streams = c["rows"] * c["channels"] * c["beam"]
        nbytes, ops = flops.int4_cross_call(streams, cfg["num_heads"], cfg["d_kv"],
                                            flops.frames(audio))
        least += c["steps"] * cfg["num_decoder_layers"] * flops.least_time(nbytes, ops)
    return 100.0 * least / seconds
