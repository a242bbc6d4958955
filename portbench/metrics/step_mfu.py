"""The model FLOPs of the traced run's window rounds outside the
profiled ones over their wall time and the H100's dense TF32 peak (495
TFLOP/s): the profiler's cost per operation would count in the profiled
rounds' wall. FLOPs a token as yardstick.model_flops_per_token counts
them; tokens a round are clients x examples x candidates x the padded
length."""
from portbench import yardstick

LAYER = "model step"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "round_ms"


def read(run):
    if run.trace is None or not run.host_rounds or run.host_window_s <= 0:
        return None
    c = run.config
    tokens = run.clients * run.examples * run.candidates * run.seq_len
    flops = tokens * yardstick.model_flops_per_token(
        c["n_layer"], c["n_embd"], c["vocab_size"], run.seq_len)
    return 100.0 * run.host_rounds * flops / (
        run.host_window_s * yardstick.TF32_FLOPS)
