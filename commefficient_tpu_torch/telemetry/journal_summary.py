"""Validate and summarize a run journal (JSONL), with the port's reader:

    python -m commefficient_tpu_torch.telemetry.journal_summary \\
        <journal.jsonl> [--quiet]

The output and exit codes are those of the JAX package's
scripts/journal_summary.py: the summary (telemetry/journal.summarize)
as one JSON line on stdout, each problem validate_journal finds as a
`journal_summary: INVALID: ...` line on stderr. A journal with no
records at all is invalid. Exit codes: 0 valid journal, 1 invariant
violations, 2 unreadable input.
"""
from __future__ import annotations

import argparse
import json
import sys

from commefficient_tpu_torch.telemetry.journal import (
    summarize, validate_journal,
)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("journal", help="path to a journal.jsonl")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the summary line (problems still "
                        "print to stderr)")
    args = p.parse_args(argv)

    counters: dict = {}
    try:
        records, problems = validate_journal(args.journal,
                                             counters=counters)
    except OSError as e:
        print(f"journal_summary: cannot read {args.journal!r}: {e}",
              file=sys.stderr)
        return 2
    if not records and not problems:
        problems = ["journal is empty (no records at all)"]
    if not args.quiet:
        print(json.dumps(summarize(
            records, corrupt_lines=counters.get("corrupt_interior", 0))))
    for prob in problems:
        print(f"journal_summary: INVALID: {prob}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main())
