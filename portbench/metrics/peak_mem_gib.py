"""torch.cuda.max_memory_allocated() over the window, its counter reset
once set-up has ended."""
LAYER = None
UNIT = "GiB"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = None


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
