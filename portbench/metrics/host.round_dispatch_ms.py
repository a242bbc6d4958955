"""Host milliseconds a round takes to enqueue its round step: the port's
`round_dispatch` spans (telemetry/trace.py), summed over the window's
rounds outside the profiled ones and divided by their count."""
LAYER = "round host"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "round_ms"


def read(run):
    spans = [s["dur"] for s in run.spans if s.get("name") == "round_dispatch"]
    if not spans or not run.host_rounds:
        return None
    return 1e3 * sum(spans) / run.host_rounds
