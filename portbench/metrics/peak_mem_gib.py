"""Peak device memory of the window: torch.cuda.max_memory_allocated()
after a reset when the window opens, in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
