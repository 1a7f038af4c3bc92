"""Device milliseconds of a train step's backward phase: the program's
`train.backward` span (`.backward()`) timed on the stream by two CUDA
events, so its kernels and any idle time between them. Mean over the
traced steps."""

from harness import program_spans


def read(run):
    return program_spans.mean_device_ms("train.backward")
