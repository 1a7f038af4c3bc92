"""Host milliseconds of a decode step's model call, the program's
`decode.step` span around `model.decode_step` in both decode loops: the
enqueue of the decoder step's operations. Mean over the traced song's
steps (recorded under the profiler, so it reads higher than untraced)."""

from harness import program_spans


def read(run):
    return program_spans.mean_host_ms("decode.step")
