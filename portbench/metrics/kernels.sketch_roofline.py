"""The count sketch's share of its roofline over the profiled rounds:
every sketch region of the round (the encode; the threshold decode's
sample and mask, or the blockwise decode's estimate windows), the sum
of each launch's bound (yardstick.region_bound) over the sum of its
device time, launches attributed by their `kernel_region` name."""
from portbench import yardstick

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "round_ms"
REGIONS = ("sketch_encode", "sketch_estimate_window", "threshold_sample",
           "threshold_mask")


def read(run):
    if run.trace is None:
        return None
    windows = yardstick.window_sizes(run.d, run.num_cols)
    bound = spent = 0.0
    for ln in run.trace.launches:
        if ln.region in REGIONS:
            bound += yardstick.region_bound(
                ln.region, ln.shapes, run.d, run.num_cols,
                windows[ln.ordinal % len(windows)])[0]
            spent += ln.seconds
    return 100.0 * bound / spent if spent else None
