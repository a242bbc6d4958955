"""The port's benchmark: the harness of BENCHMARK.json (run.py), its
yardstick and its plain reference."""
