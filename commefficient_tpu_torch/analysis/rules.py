"""graftlint's host rules, the port of commefficient_tpu/analysis/
rules.py: GL005, GL006, GL009, GL011, GL012 and GL014, with the JAX
package's codes, patterns and wording.

Each rule is a function ``check(module: ModuleInfo) -> Iterator[
Violation]`` over one parsed file, mechanical and precise rather than
broad: a lint that cries wolf gets disabled, a narrow one stays armed.
All six read host code, which the port shares with the JAX package in
kind (writer threads, atomic files, PRNG domains, controllers), so on
the same source both packages report the same (rule, line, column).

The JAX package's other rules (GL001-GL004, GL007, GL008, GL010, GL013)
walk code that jax.jit, vmap, shard_map or lax.scan trace; the port
traces nothing, and their torch counterparts wait for the trace tiers
(ROADMAP.md item 10f).
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Set, Tuple

from commefficient_tpu_torch.analysis.domains import CONTROL_FIELDS
from commefficient_tpu_torch.analysis.engine import Violation

# ---------------------------------------------------------------------------
# shared AST helpers


def _dotted(node: ast.AST) -> Optional[str]:
    """Dotted source name of a Name/Attribute chain ('os.replace'), or
    None when the expression is not a plain chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _terminal(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


class ModuleInfo:
    """One parsed file plus what the rules share: parent links and the
    source text."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    def enclosing_functions(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                yield cur
            cur = self.parents.get(cur)

    def segment(self, node: ast.AST) -> str:
        return ast.get_source_segment(self.source, node) or ""


# ---------------------------------------------------------------------------
# GL005 — fault-swallowing broad except handlers

_BROAD = frozenset({"Exception", "BaseException"})


def _names_broad(type_expr: Optional[ast.expr]) -> bool:
    if type_expr is None:
        return True  # bare `except:`
    if isinstance(type_expr, ast.Tuple):
        return any(_names_broad(e) for e in type_expr.elts)
    return _terminal(_dotted(type_expr)) in _BROAD


def _reraises(handler: ast.ExceptHandler) -> bool:
    """A bare `raise` anywhere in the handler: the cleanup-then-reraise
    and classify-then-reraise idioms (multihost.initialize,
    utils/retry)."""
    return any(isinstance(node, ast.Raise) and node.exc is None
               for node in ast.walk(handler))


def check_gl005(module: ModuleInfo) -> Iterator[Violation]:
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if _names_broad(node.type) and not _reraises(node):
            caught = (module.segment(node.type) if node.type is not None
                      else "<bare>")
            yield Violation(
                module.path, node.lineno, node.col_offset, "GL005",
                f"broad `except {caught}` without re-raise would swallow "
                "InjectedFault and defeat the fault harness (and mask "
                "real config errors as transients); catch the specific "
                "expected exceptions, or re-raise")


# ---------------------------------------------------------------------------
# GL006 — non-atomic file writes

_WRITE_MODES = ("w", "a", "x", "+")
_SAVES = ("np.save", "np.savez", "np.savez_compressed", "numpy.save",
          "numpy.savez", "numpy.savez_compressed")


def _enclosing_scope_calls_replace(module: ModuleInfo,
                                   node: ast.AST) -> bool:
    scope = next(module.enclosing_functions(node), module.tree)
    return any(isinstance(n, ast.Call)
               and _dotted(n.func) in ("os.replace", "os.rename")
               for n in ast.walk(scope))


def _mentions_tmp(module: ModuleInfo, expr: ast.AST) -> bool:
    return "tmp" in module.segment(expr).lower()


def _write_mode(node: ast.Call) -> bool:
    mode = node.args[1] if len(node.args) >= 2 else next(
        (kw.value for kw in node.keywords if kw.arg == "mode"), None)
    return (isinstance(mode, ast.Constant) and isinstance(mode.value, str)
            and any(ch in mode.value for ch in _WRITE_MODES))


def check_gl006(module: ModuleInfo) -> Iterator[Violation]:
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        target = node.args[0] if node.args else None
        if name in ("open", "io.open") or (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "open" and name is None):
            if not _write_mode(node):
                continue
            if target is None or _mentions_tmp(module, target):
                continue
            if _enclosing_scope_calls_replace(module, node):
                continue
            yield Violation(
                module.path, node.lineno, node.col_offset, "GL006",
                "open-for-write without the atomic `.tmp` + os.replace "
                "pattern (utils/atomic_io): a preemption mid-write "
                "corrupts the previous file in place; write to "
                "`<path>.tmp` and os.replace, or use "
                "atomic_write_text/atomic_savez")
        elif name in _SAVES:
            # a bare Name is typically an open file handle (already
            # routed through the atomic open) or a precomputed tmp path
            if target is None or isinstance(target, ast.Name):
                continue
            if _mentions_tmp(module, target):
                continue
            if _enclosing_scope_calls_replace(module, node):
                continue
            yield Violation(
                module.path, node.lineno, node.col_offset, "GL006",
                f"`{name}` straight to its destination path: a "
                "preemption mid-serialize leaves a torn archive under "
                "the real name; use utils/atomic_io.atomic_savez")


# ---------------------------------------------------------------------------
# GL009 — PRNG-domain constants outside the central registry
#
# (a) an inline hex literal fed to `fold_in` / `SeedSequence` is a domain
# tag that bypassed the registry (invisible to its uniqueness assert);
# (b) a duplicate value inside the registry dict is a collision,
# re-proven on the literal dict (the lint never executes the tree).

_GL009_SINKS = frozenset({"fold_in", "SeedSequence"})
_REGISTRY_SUFFIX = "analysis/domains.py"


def _is_hex_literal(module: ModuleInfo, node: ast.AST) -> bool:
    if not (isinstance(node, ast.Constant) and isinstance(node.value, int)
            and not isinstance(node.value, bool)):
        return False
    return module.segment(node).strip().lower().startswith("0x")


def _registry_dicts(module: ModuleInfo, name: str) -> Iterator[ast.Dict]:
    """The literal dicts assigned to `name` in analysis/domains.py."""
    if not module.path.replace(os.sep, "/").endswith(_REGISTRY_SUFFIX):
        return
    for node in ast.walk(module.tree):
        if (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in node.targets)
                and isinstance(node.value, ast.Dict)):
            yield node.value


def _registry_collisions(module: ModuleInfo, d: ast.Dict, kind
                         ) -> Iterator[Tuple[ast.AST, str, str]]:
    """(value node, its key's name, the first key's name) for each
    repeated value of type `kind` in the literal dict `d`."""
    seen: Dict[object, str] = {}
    for k, v in zip(d.keys, d.values):
        if not (isinstance(v, ast.Constant) and isinstance(v.value, kind)):
            continue
        name = k.value if isinstance(k, ast.Constant) else module.segment(k)
        if v.value in seen:
            yield v, name, seen[v.value]
        else:
            seen[v.value] = name


def check_gl009(module: ModuleInfo) -> Iterator[Violation]:
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        if _terminal(_dotted(node.func)) not in _GL009_SINKS:
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for sub in ast.walk(arg):
                if _is_hex_literal(module, sub):
                    yield Violation(
                        module.path, sub.lineno, sub.col_offset, "GL009",
                        f"inline hex domain tag `{module.segment(sub)}` "
                        "in a PRNG key derivation: domain constants "
                        "must come from analysis/domains.DOMAINS (the "
                        "registry asserts stream uniqueness; an inline "
                        "tag can silently collide with an existing "
                        "stream)")
    for d in _registry_dicts(module, "DOMAINS"):
        for v, name, first in _registry_collisions(module, d, int):
            yield Violation(
                module.path, v.lineno, v.col_offset, "GL009",
                f"PRNG domain collision: {name!r} reuses tag "
                f"{hex(v.value)} already registered to {first!r} — "
                "correlated streams break the "
                "independent-failure-process model")


# ---------------------------------------------------------------------------
# GL011 — wall-clock deltas used as durations
#
# time.time() steps under NTP correction, so its differences are not
# durations. Syntactic and local: a subtraction where BOTH operands are
# wall-clock-derived (a time.time()/time.time_ns() call, or a name bound
# from one in the same function scope). time.time() against an offset or
# a file mtime is a legitimate wall-clock comparison and stays quiet.

_GL011_WALL_CALLS = frozenset({"time.time", "time.time_ns"})


def _is_wall_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and (_dotted(node.func) or "") in _GL011_WALL_CALLS)


def _gl011_scopes(tree: ast.Module) -> Iterator[ast.AST]:
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _gl011_scope_nodes(scope: ast.AST) -> Iterator[ast.AST]:
    """Nodes lexically in `scope` itself, nested function bodies pruned
    (each is its own scope)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def check_gl011(module: ModuleInfo) -> Iterator[Violation]:
    seen: Set[Tuple[int, int]] = set()
    for scope in _gl011_scopes(module.tree):
        wall_names: Set[str] = set()
        for node in _gl011_scope_nodes(scope):
            if isinstance(node, ast.Assign) and _is_wall_call(node.value):
                wall_names.update(t.id for t in node.targets
                                  if isinstance(t, ast.Name))
            elif (isinstance(node, ast.AnnAssign)
                    and node.value is not None
                    and _is_wall_call(node.value)
                    and isinstance(node.target, ast.Name)):
                wall_names.add(node.target.id)

        def _wall_derived(expr: ast.AST) -> Optional[str]:
            if _is_wall_call(expr):
                return f"{_dotted(expr.func)}()"
            if isinstance(expr, ast.Name) and expr.id in wall_names:
                return f"`{expr.id}` (assigned from time.time())"
            return None

        for node in _gl011_scope_nodes(scope):
            if not (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Sub)):
                continue
            key = (node.lineno, node.col_offset)
            if key in seen:
                continue
            left = _wall_derived(node.left)
            right = _wall_derived(node.right)
            if left is None or right is None:
                continue
            seen.add(key)
            yield Violation(
                module.path, node.lineno, node.col_offset, "GL011",
                f"wall-clock delta used as a duration: {left} - "
                f"{right}. time.time() steps under NTP correction, "
                "so its differences are not durations — use "
                "time.monotonic()/time.perf_counter() for intervals "
                "(keep time.time() for timestamps and comparisons "
                "against external wall-clock values like file "
                "mtimes)")


# ---------------------------------------------------------------------------
# GL012 — anonymous threads
#
# The trace rings and the journal's trace records key spans by thread
# NAME; an anonymous thread's Thread-N counter name differs across
# restarts, so a resumed run's spans land on another row. Every
# `threading.Thread(...)` passes an explicit `name=` (**kwargs
# forwarding, or a third positional argument, may carry it).


def check_gl012(module: ModuleInfo) -> Iterator[Violation]:
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        if _dotted(node.func) not in ("threading.Thread", "Thread"):
            continue
        if any(kw.arg is None or kw.arg == "name" for kw in node.keywords):
            continue
        if (len(node.args) >= 3
                or any(isinstance(a, ast.Starred) for a in node.args)):
            continue
        yield Violation(
            module.path, node.lineno, node.col_offset, "GL012",
            "`threading.Thread(...)` without an explicit `name=`: the "
            "interpreter's Thread-N fallback differs across restarts, "
            "so graftscope's thread-keyed trace rows (and the "
            "watchdog's writer-naming) break across a resume; name "
            "the thread after its role (journal-writer, "
            "state-spill-writer)")


# ---------------------------------------------------------------------------
# GL014 — controller wire fields outside the central registry
#
# (a) a `WIRE_FIELD = "..."` class attribute anywhere in the tree whose
# literal is not a registered CONTROL_FIELDS value; (b) a duplicate
# value inside the registry dict itself.

_GL014_ATTR = "WIRE_FIELD"


def check_gl014(module: ModuleInfo) -> Iterator[Violation]:
    registered = set(CONTROL_FIELDS.values())
    for node in ast.walk(module.tree):
        if not (isinstance(node, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == _GL014_ATTR
                        for t in node.targets)
                and isinstance(node.value, ast.Constant)
                and isinstance(node.value.value, str)):
            continue
        field = node.value.value
        if field and field not in registered:
            yield Violation(
                module.path, node.lineno, node.col_offset, "GL014",
                f"controller wire field {field!r} is not registered "
                "in analysis/domains.CONTROL_FIELDS: the registry is "
                "where wire-field uniqueness is asserted — an "
                "unregistered field can silently collide with an "
                "existing controller's journaled plan stream")
    for d in _registry_dicts(module, "CONTROL_FIELDS"):
        for v, name, first in _registry_collisions(module, d, str):
            yield Violation(
                module.path, v.lineno, v.col_offset, "GL014",
                f"controller wire-field collision: {name!r} "
                f"reuses field {v.value!r} already registered to "
                f"{first!r} — two controllers on one wire "
                "field overwrite each other's plan-carried "
                "adjustments")


# ---------------------------------------------------------------------------

ALL_RULES = {
    "GL005": check_gl005,
    "GL006": check_gl006,
    "GL009": check_gl009,
    "GL011": check_gl011,
    "GL012": check_gl012,
    "GL014": check_gl014,
}

RULE_DOCS = {
    "GL005": "broad except handler that would swallow InjectedFault "
             "(no re-raise)",
    "GL006": "file write without the atomic .tmp + os.replace pattern",
    "GL009": "PRNG domain tag outside the analysis/domains registry "
             "(inline hex in fold_in/SeedSequence, or a registry "
             "collision)",
    "GL011": "wall-clock delta (time.time() difference) used as a "
             "duration — NTP steps corrupt it; use "
             "time.monotonic()/perf_counter for intervals",
    "GL012": "threading.Thread constructed without an explicit name= "
             "(anonymous Thread-N names break graftscope's "
             "thread-keyed trace rows across restarts)",
    "GL014": "controller plan wire field outside the analysis/domains "
             "CONTROL_FIELDS registry (unregistered WIRE_FIELD class "
             "attribute, or a registry collision)",
}
