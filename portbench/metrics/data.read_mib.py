"""MiB of the corpus file's members a round's fetch materializes: the
`bytes_read` counters of the loader's `data_fetch` spans (PERSONA
reads each member it indexes whole, once a client), summed over the
window's rounds outside the profiled ones and divided by their count."""
LAYER = "data"
UNIT = "MiB"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "round_ms"


def read(run):
    spans = [s for s in run.spans if s.get("name") == "data_fetch"]
    if not spans or not run.host_rounds:
        return None
    return sum(s.get("bytes_read", 0) for s in spans) / 2 ** 20 / (
        run.host_rounds)
