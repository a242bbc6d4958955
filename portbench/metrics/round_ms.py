"""The window's wall time over the rounds completed in it: rounds back
to back, the window ended by one synchronize. A whole-window mean, so a
stall anywhere in the window shows."""
LAYER = None
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = None


def read(run):
    return 1e3 * run.window_s / run.rounds if run.rounds else None
