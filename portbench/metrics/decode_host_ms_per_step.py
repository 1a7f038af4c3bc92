"""Wall time inside the window's greedy_decode and beam_decode calls over
their steps, in ms: how long the host takes per decode step. Read from
the untraced window, which a traced run measures before its traced songs."""


def read(run):
    calls = [c for c in run.calls if not c["traced"]]
    steps = sum(c["steps"] for c in calls)
    return 1e3 * sum(c["host_s"] for c in calls) / steps if steps else None
