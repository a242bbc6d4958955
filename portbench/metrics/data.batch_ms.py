"""Host milliseconds a round spends drawing its batch: the benchmark's
own clock around each next() of the loader it hands train_gpt2, summed
over the window's rounds outside the profiled ones and divided by their
count (chip_smoke.py's TimedLoader arithmetic)."""
LAYER = "data"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "round_ms"


def read(run):
    if not run.batch_s or not run.host_rounds:
        return None
    return 1e3 * sum(run.batch_s) / run.host_rounds
