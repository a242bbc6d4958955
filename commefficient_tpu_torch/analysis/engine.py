"""graftlint's engine, the port of commefficient_tpu/analysis/engine.py:
parse, run the rules, apply the suppressions and a baseline.

Pure `ast` plus the stdlib, so the pass runs anywhere (no torch, no
card). Rule logic lives in `rules`; this module owns what every rule
shares:

  * per-line suppressions: ``# graftlint: disable=GL005[,GL006]`` on
    the reported line silences those rules there, with the reason after
    ``--``;
  * `Baseline`: grandfathered hits per (path, rule), matched EXACTLY
    (a group with more hits than its entry re-reports the group, one
    with fewer is stale). The port keeps no baseline file: its tree is
    held at zero hits by in-line suppressions, each with its reason, so
    the CLI reads none and writes none; the class serves callers that
    hold a baseline of their own;
  * `find_cycles`, the one cycle definition graftsync's static
    lock-order rule (SY002) and the runtime LockOrderSanitizer share.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclasses.dataclass(frozen=True, order=True)
class Violation:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col + 1}: " \
               f"{self.rule} {self.message}"


class LintError(RuntimeError):
    """A file could not be linted (unreadable / syntax error)."""


def suppressions(source: str, pattern=_SUPPRESS_RE) -> Dict[int, set]:
    """{line: rule codes} of the source's `disable=` comments (graftsync
    passes its own pattern)."""
    out: Dict[int, set] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = pattern.search(line)
        if m:
            out[i] = {r.strip().upper() for r in m.group(1).split(",")
                      if r.strip()}
    return out


def lint_source(path: str, source: str,
                rules: Optional[Dict] = None) -> List[Violation]:
    """Lint one file's source. `path` is used for reporting (and by the
    registry rules, which recognise analysis/domains.py by it)."""
    from commefficient_tpu_torch.analysis.rules import ALL_RULES, ModuleInfo
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        raise LintError(f"{path}: syntax error: {e}") from e
    module = ModuleInfo(path, source, tree)
    suppressed = suppressions(source)
    out: List[Violation] = []
    for check in (rules or ALL_RULES).values():
        for v in check(module):
            if v.rule in suppressed.get(v.line, ()):
                continue
            out.append(v)
    return sorted(set(out))


def iter_python_files(paths: Sequence[str],
                      exclude: Sequence[str] = ()) -> Iterable[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", ".git"))
            for f in sorted(files):
                if not f.endswith(".py"):
                    continue
                full = os.path.join(root, f)
                rel = full.replace(os.sep, "/")
                if any(pat in rel for pat in exclude):
                    continue
                yield full


def lint_paths(paths: Sequence[str], exclude: Sequence[str] = (),
               rules: Optional[Dict] = None) -> List[Violation]:
    """Every file under `paths`, reported by its path relative to the
    working directory."""
    out: List[Violation] = []
    for path in iter_python_files(paths, exclude):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        except OSError as e:
            raise LintError(f"{path}: unreadable: {e}") from e
        rel = os.path.relpath(path).replace(os.sep, "/")
        out.extend(lint_source(rel, source, rules))
    return sorted(out)


# ---------------------------------------------------------------------------
# graph utilities shared by the concurrency tiers


def find_cycles(graph: Dict[str, Sequence[str]]) -> List[List[str]]:
    """Distinct cycles of a directed graph ({node: successors}), each as
    [a, b, ..., a], one per node SET. A colour-marking DFS over sorted
    nodes, so the result is deterministic."""
    cycles: List[List[str]] = []
    seen: set = set()
    state: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(v: str) -> None:
        state[v] = 1
        stack.append(v)
        for w in sorted(graph.get(v, ())):
            if state.get(w, 0) == 0:
                dfs(w)
            elif state.get(w) == 1:
                cyc = stack[stack.index(w):] + [w]
                canon = tuple(sorted(cyc[:-1]))
                if canon not in seen:
                    seen.add(canon)
                    cycles.append(cyc)
        stack.pop()
        state[v] = 2

    for v in sorted(graph):
        if state.get(v, 0) == 0:
            dfs(v)
    return cycles


def edges_to_graph(edges) -> Dict[str, List[str]]:
    """(a, b) edge keys -> the {node: successors} map find_cycles takes
    (every node a key)."""
    graph: Dict[str, List[str]] = {}
    for a, b in edges:
        graph.setdefault(a, []).append(b)
        graph.setdefault(b, [])
    return graph


# ---------------------------------------------------------------------------
# baseline


class Baseline:
    """Grandfathered hits: {(path, rule): (count, justification)}."""

    def __init__(self, entries: Optional[Dict[Tuple[str, str],
                                              Tuple[int, str]]] = None):
        self.entries = dict(entries or {})

    @classmethod
    def load(cls, path: str) -> "Baseline":
        """The JAX package's baseline format ({"entries": [{path, rule,
        count, justification}]})."""
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
        return cls({(e["path"], e["rule"]): (int(e["count"]),
                                             e.get("justification", ""))
                    for e in raw.get("entries", ())})

    @classmethod
    def from_violations(cls, violations: Sequence[Violation]
                        ) -> "Baseline":
        counts: Dict[Tuple[str, str], int] = {}
        for v in violations:
            counts[(v.path, v.rule)] = counts.get((v.path, v.rule), 0) + 1
        return cls({k: (n, "TODO: justify or fix")
                    for k, n in counts.items()})

    def apply(self, violations: Sequence[Violation]
              ) -> Tuple[List[Violation], List[str]]:
        """(new violations, stale messages): a (path, rule) group with
        more hits than its entry is re-reported whole (line numbers
        churn, so which hit is new is unknowable); a group with fewer is
        stale."""
        by_key: Dict[Tuple[str, str], List[Violation]] = {}
        for v in violations:
            by_key.setdefault((v.path, v.rule), []).append(v)
        new: List[Violation] = []
        stale: List[str] = []
        for key, vs in sorted(by_key.items()):
            if len(vs) > self.entries.get(key, (0, ""))[0]:
                new.extend(vs)
        for key, (count, _) in sorted(self.entries.items()):
            have = len(by_key.get(key, ()))
            if have < count:
                stale.append(
                    f"stale baseline entry {key[0]} {key[1]}: baseline "
                    f"grandfathers {count}, tree has {have}")
            elif have > count > 0:
                stale.append(
                    f"baseline entry {key[0]} {key[1]} exceeded: "
                    f"grandfathers {count}, tree has {have}")
        return new, stale
