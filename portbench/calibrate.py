"""Readings the limits of `limits/<cell>.json` are set from, many seeds
in one process (set-up is paid once for the kernels' build):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --mode program|control|<fault> [--seconds 2] [--out FILE]

  program  the timed path as a benchmark run drives it (a short window);
           the lower readings;
  control  the plain reference in TF32 put in the program's place,
           against the reference in float32, on the rounds the
           program's data layer draws; the upper readings;
  <fault>  a fault of portbench/faults.py planted under the timed path.

One JSON line a seed (the compared numbers, the readings they are
worked out from, set-up and reference seconds) on standard output, and
appended to --out.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import check, faults, harness, spec
    harness.set_cache_dirs(ROOT)
    import torch
    cell = spec.load_cell(args.workload, os.path.join(ROOT, "BENCHMARK.json"))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = {"workload": args.workload, "mode": args.mode, "seed": seed}
        if args.mode == "control":
            raw, batches, leaves = harness.first_batches(cell, seed, "cuda")
            row["readings"] = {}
            row["numbers"] = check.against_reference(
                cell.config, cell.traffic, raw, {"batches": batches}, seed,
                leaves, torch.device("cuda"), tf32_program=True,
                out=row["readings"])
        else:
            fault = (None if args.mode == "program"
                     else faults.FAULTS[args.mode])
            r = harness.run(cell, seed, args.seconds, False, "cuda",
                            fault=fault)
            row.update(numbers=r.numbers, readings=r.readings,
                       setup_s=r.setup_s, setup_phases=r.setup_phases,
                       reference_s=r.reference_s, rounds=r.rounds,
                       round_ms=1e3 * r.window_s / max(r.rounds, 1),
                       peak_gib=r.peak_bytes / 2 ** 30, L=r.seq_len, d=r.d)
            del r
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
