"""CLI: ``python -m commefficient_tpu_torch.analysis [paths...]``.

Lints the port package by default (run it from the repo root), with
every graftlint rule (analysis/rules.py: the host rules, and the rules
over the round's path and the rank layer). Exit codes are the JAX
package's: 0 clean, 1 violations or lint errors, 2 usage errors (a
path that does not exist). The port keeps no baseline file and reads no
pyproject.toml table: its tree is held at zero hits, each deliberate
exception suppressed on its line with its reason.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

from commefficient_tpu_torch.analysis.engine import LintError, lint_paths
from commefficient_tpu_torch.analysis.rules import RULE_DOCS

DEFAULT_PATHS = ["commefficient_tpu_torch"]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftlint",
        description="host-code static analysis of the port (rules "
                    f"{', '.join(sorted(RULE_DOCS))}; see --list-rules)")
    ap.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                    help="files/directories to lint")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code, doc in sorted(RULE_DOCS.items()):
            print(f"{code}  {doc}")
        return 0
    for p in args.paths:
        if not os.path.exists(p):
            print(f"graftlint: no such path: {p}", file=sys.stderr)
            return 2
    try:
        violations = lint_paths(args.paths)
    except LintError as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return 1
    for v in violations:
        print(v.render())
    if violations:
        print(f"graftlint: {len(violations)} violation(s)")
        return 1
    print("graftlint: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
