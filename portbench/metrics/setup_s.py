"""Process start to the window's first round: imports, the corpus and
its tokenization, the model, the kernels' build or load, the weights,
and the rounds the reference follows."""
LAYER = None
UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = None


def read(run):
    return run.setup_s
