"""Host milliseconds a round spends enqueuing the server's step (the
momentum, the sketch's decode and the re-encode): the port's
`server_update` spans (federated/round.py), summed over the window's
rounds outside the profiled ones and divided by their count."""
LAYER = "round host"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "round_ms"


def read(run):
    spans = [s["dur"] for s in run.spans
             if s.get("name") == "server_update"]
    if not spans or not run.host_rounds:
        return None
    return 1e3 * sum(spans) / run.host_rounds
