"""Host milliseconds a round spends fetching its batch inside the
port's data layer: the loader's `data_fetch` spans
(data/loader.FedLoader.epoch), summed over the window's rounds outside
the profiled ones and divided by their count."""
LAYER = "data"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "round_ms"


def read(run):
    spans = [s["dur"] for s in run.spans if s.get("name") == "data_fetch"]
    if not spans or not run.host_rounds:
        return None
    return 1e3 * sum(spans) / run.host_rounds
