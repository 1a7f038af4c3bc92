"""The untraced window's training operations (counts/flops.py: forward and
backward, the mixture of experts at its routed top-k only) over the
window's time, as a share of the H100's dense bf16 peak, in %."""

from counts import flops


def read(run):
    if "steps" not in run.counts or run.window_s <= 0:
        return None
    ops = run.counts["steps"] * flops.train_step(run.cell.config, run.counts["batch"])
    return 100.0 * ops / (run.window_s * flops.PEAK_BF16)
