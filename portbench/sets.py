"""The runs the bounds of BENCHMARK.json are set from: for one cell, two
sets of runs on the same seeds with --trace 0, then traced runs, each a
new process of run.py, one after another on one card:

    python3 portbench/sets.py --workload <cell> --seeds 1,2,3,4,5,6 \\
        --traced 7,8,9 --out FILE

Each result line goes to --out (JSON lines, with the run's trace flag,
seed, exit code and wall seconds); the end prints each end-to-end
metric's median and spread a set: the distance between the first and
third quartiles (statistics.quantiles, n=4) over the median. The first
run's set-up, which builds the kernels, is left out of its set's.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def spread(values: list) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], capture_output=True, text=True,
        cwd=os.path.dirname(HERE))
    lines = p.stdout.strip().splitlines()
    row = json.loads(lines[-1]) if p.returncode == 0 and lines else {}
    row.update(_trace=trace, _seed=seed, _rc=p.returncode,
               _wall=time.perf_counter() - t0)
    if p.returncode:
        row["_stderr"] = p.stderr[-3000:]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--traced", default="")
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    traced = [int(s) for s in args.traced.split(",") if s]
    plan = [(s, 0) for _ in range(args.sets) for s in seeds]
    plan += [(s, 1) for s in traced]
    rows = []
    for seed, trace in plan:
        row = one_run(args.workload, seed, seconds, trace)
        rows.append(row)
        with open(args.out, "a") as f:
            f.write(json.dumps(row) + "\n")
    untraced = [r for r in rows if r["_trace"] == 0 and r["_rc"] == 0]
    for k in range(args.sets):
        part = untraced[k * len(seeds):(k + 1) * len(seeds)]
        for name in sorted(part[0]["metrics"]) if part else ():
            v = [r["metrics"][name]["value"] for r in part]
            if name == "setup_s" and k == 0:
                v = v[1:]
            if len(v) >= 3:
                print(f"set {k + 1} {name}: median {statistics.median(v)!r}"
                      f" spread {spread(v)!r}")
    print("exit codes", [r["_rc"] for r in rows], "correct",
          [r.get("correct") for r in rows])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
