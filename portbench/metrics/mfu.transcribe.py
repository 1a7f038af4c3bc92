"""The model's operations in the untraced window (counts/flops.py and the
configuration's encoder count: for every decode call, the encoder batch
before it and the call's steps, each on its real segments' streams, beams
included; padding rows are not counted) over the window's time, as a
share of the H100's dense bf16 peak, in %."""

from counts import flops


def read(run):
    calls = [c for c in run.calls if not c["traced"]]
    if not calls or run.window_s <= 0:
        return None
    config = run.cell.config
    cfg, audio = config["model"], config["audio"]
    ops = 0.0
    for c in calls:
        ops += flops.encoder_forward(config, c["real"]) + flops.decode(
            cfg, audio, c["real"] * c["channels"] * c["beam"], c["steps"])
    return 100.0 * ops / (run.window_s * flops.PEAK_BF16)
