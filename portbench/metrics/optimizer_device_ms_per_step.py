"""Device milliseconds of a train step's optimizer phase: the program's
`train.optimizer` span (the gradients taken, their global norm and clip,
the optimizer's update and its in-place add) timed on the stream by two
CUDA events, so its kernels and any idle time between them. Mean over the
traced steps."""

from harness import program_spans


def read(run):
    return program_spans.mean_device_ms("train.optimizer")
