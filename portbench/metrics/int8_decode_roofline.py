"""The dense int8 decode-attention kernel's share of its roofline: over
every decode call of the traced songs, every step p and every decoder
layer, the least time of one self-attention read of the p + 1 live
positions (bytes over HBM bandwidth or fp32 operations over the fp32 peak,
counts/flops.py: bf16 q and out, int8 K and V and their fp32 row scales,
each moved once, over the padded rows' streams and beams), over the device
time of the kernel named here, in %. In mc13.transcribe the kernel serves
the self-attention alone (the int4 kernel takes the cross-attention). A
program without the kernel traces none: None."""

from counts import flops

KERNELS = ("int8_decode_kernel",)


def read(run):
    if run.trace is None:
        return None
    launches, seconds = run.trace.kernel_seconds(KERNELS)
    if not launches or seconds <= 0:
        return None
    cfg = run.cell.config["model"]
    least = 0.0
    for c in (c for c in run.calls if c["traced"]):
        streams = c["rows"] * c["channels"] * c["beam"]
        for p in range(c["steps"]):
            nbytes, ops = flops.paged_decode_call(streams, cfg["num_heads"], cfg["d_kv"],
                                                  p + 1)
            least += cfg["num_decoder_layers"] * flops.least_time(nbytes, ops)
    return 100.0 * least / seconds
