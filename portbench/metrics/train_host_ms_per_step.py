"""Host milliseconds of a train step, the program's `train.step` span
around the step function in `trainer.train` (input, frontend, forward,
backward and optimizer enqueued; no host read). Mean over the traced
steps."""

from harness import program_spans


def read(run):
    return program_spans.mean_host_ms("train.step")
