"""The attention forward's share of its roofline over the profiled
rounds: the sum of each launch's bound (yardstick.region_bound) over
the sum of its device time, launches attributed by their
`kernel_region` name, `flash_fwd`."""
from portbench import yardstick

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "round_ms"
REGIONS = ("flash_fwd",)


def read(run):
    if run.trace is None:
        return None
    bound = spent = 0.0
    for ln in run.trace.launches:
        if ln.region in REGIONS:
            bound += yardstick.region_bound(ln.region, ln.shapes, run.d,
                                            run.num_cols)[0]
            spent += ln.seconds
    return 100.0 * bound / spent if spent else None
