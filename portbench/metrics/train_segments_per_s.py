"""2.048-s segments trained per wall second: the window's steps times the
batch over the window's whole time, closed by a synchronise (host clock)."""


def read(run):
    if "segments" not in run.counts or run.window_s <= 0:
        return None
    return run.counts["segments"] / run.window_s
