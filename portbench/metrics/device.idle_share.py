"""The share of the profiled rounds' wall in which the device ran no
kernel, copy or set: 1 minus the union of their intervals over the
window, from the profiler's device trace."""
LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "round_ms"


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
