"""Process start to window open, host clock: imports, library load (and
build, in a fresh checkout), weights on the device, inputs, warm-up."""


def read(run):
    return run.setup_s
