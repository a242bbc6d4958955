"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds BENCHMARK.json. --trace 0
reports the cell's end-to-end metrics, --trace 1 its per-layer ones;
both compare the timed path with the plain reference. The last line of
standard output is one JSON object; the numbers compared, each beside
its limit, are the last lines of standard error. Exits non-zero, with
no result, without a CUDA card (or fewer than the cell asks for), when
the run fails, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "commefficient_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def metric_values(r, entries: list, dirs=None) -> dict:
    from portbench import spec
    out = {}
    for m in entries:
        v = spec.load_metric(m["name"], dirs).read(r)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def result_line(r, trace: bool, device: dict, dirs=None) -> dict:
    cell = r.cell
    line = {"correct": bool(r.correct), "attempted": int(r.rounds),
            "failed": int(r.failed_rounds),
            "metrics": metric_values(
                r, cell.per_layer if trace else cell.end_to_end, dirs),
            "device": device}
    if trace and r.trace is not None:
        device["busy_s"] = r.trace.busy_s
        device["window_s"] = r.trace.window_s
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in r.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in r.trace.idle_gaps]}
    line["setup_phases"] = r.setup_phases
    line["checks"] = r.checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    try:
        from portbench import harness, spec
        harness.set_cache_dirs(ROOT)
        import torch
        cell = spec.load_cell(args.workload,
                              os.path.join(ROOT, "BENCHMARK.json"))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < cell.chips:
            print(f"portbench: {args.workload} needs {cell.chips} CUDA "
                  f"card(s); this machine has {cards}", file=sys.stderr)
            return 2
        r = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                        "cuda", T_START)
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": cell.chips, "memory_peak_bytes": int(r.peak_bytes)}
        line = result_line(r, bool(args.trace), device)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print("setup phases " + " ".join(
        f"{k} {v:.3f}" for k, v in r.setup_phases.items()), file=sys.stderr)
    for name, c in r.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
