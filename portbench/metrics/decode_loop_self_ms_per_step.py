"""Host milliseconds a decode step spends in the loop's own work: the
program's `decode.greedy` and `decode.beam` spans (the step loops) less
their direct children (`decode.step`, the model call, and
`decode.done_read`, the host read of the done flags), over the number of
`decode.step` spans: sampling, beam bookkeeping, cache reorders and the
loop's Python. Over the traced song."""

from harness import program_spans


def read(run):
    got = program_spans.spans()
    loops = {sp.id: sp for sp in got if sp.name in ("decode.greedy", "decode.beam")}
    steps = sum(sp.name == "decode.step" for sp in got)
    if not loops or not steps:
        return None
    total = sum(sp.t1_ns - sp.t0_ns for sp in loops.values())
    total -= sum(sp.t1_ns - sp.t0_ns for sp in got if sp.parent in loops)
    return 1e-6 * total / steps
