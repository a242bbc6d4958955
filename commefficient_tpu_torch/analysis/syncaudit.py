"""graftsync, the port of commefficient_tpu/analysis/syncaudit.py: the
static concurrency and durability-ordering audit of the port's host
code, pure `ast` plus the stdlib, over its seven host packages
(telemetry, utils, federated, parallel, training, scheduler, control).

The port's control plane runs the JAX package's threads: the journal,
checkpoint and state-spill bounded-queue writers, the span loop's
staging thread, per-thread trace rings, the write-ahead plan journal
and the tiered store's plan/execute split. Their correctness rests on
lock discipline and on a few happens-before edges, which this audit
makes mechanical with the JAX package's rules and wording:

  SY001  shared-state guard discipline: a mutation of a `Class.attr`
         registered in analysis/domains.SHARED_STATE outside `with
         self.<guard>:`, or an attribute mutated both from a thread-entry
         function (a Thread target, a closure handed to a writer's
         `.submit`, and what those reach through same-class `self.*()`
         calls) and from outside one that is not registered.
  SY002  a cycle in the static lock-acquisition-order graph (nested
         `with lock:` scopes and `.acquire()` under a held lock, the
         union over every file): a latent ABBA deadlock.
  SY003  a value `put()` on a writer queue or `submit()`ted to a writer
         and mutated afterwards on the producer side.
  SY004  a blocking call under a held lock: fsync, os.replace, a
         blocking queue put, join, acquire, a device sync. The port's
         device sync is `.synchronize()` (a CUDA event's or the
         device's), which the port adds to the JAX package's
         `block_until_ready` / `gather_host`.
  SY005  a threading.Thread with no reachable join on its binding in
         the file.
  SY006  the named happens-before edges of analysis/domains.
         ORDERING_EDGES, each a call-order dominance in one function of
         the port: `before` present, and its first call ahead of every
         call of `after`. A missing file, function or `after` is a
         finding too: an edge is re-registered on its new home, never
         dropped.

Per-line suppressions are ``# graftsync: disable=SYxxx -- reason``.
The port keeps no baseline file: its tree audits clean. Exit codes are
the JAX package's: 0 clean, 1 rule violations, 3 a path that does not
exist. The report's digest (sha256 over the rule and file counts and
the registry sizes) is bit-identical across runs; ``--journal`` appends
it as a `sync_audit_digest` event, which telemetry/journal.
validate_journal checks.

The runtime twin, the LockOrderSanitizer that records the real
acquisition edges and asserts their graph acyclic, is in
analysis/runtime.py.
"""
from __future__ import annotations

import argparse
import ast
import hashlib
import json
import os
import re
import sys
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from commefficient_tpu_torch.analysis.domains import (
    ORDERING_EDGES, SHARED_STATE,
)
from commefficient_tpu_torch.analysis.engine import (
    Violation, edges_to_graph, find_cycles, iter_python_files,
    suppressions,
)
from commefficient_tpu_torch.analysis.rules import _dotted, _terminal

SYNC_RULE_DOCS = {
    "SY001": "mutation of registered shared state outside its guard "
             "lock (analysis/domains.SHARED_STATE), or cross-thread-"
             "mutated state missing from the registry",
    "SY002": "cycle in the static lock-acquisition-order graph "
             "(nested `with lock:` scopes) — a latent ABBA deadlock",
    "SY003": "producer-side mutation of a value after it was put() on "
             "a writer queue / submit()ed to a writer thread",
    "SY004": "blocking call (fsync / os.replace / queue put / join / "
             "acquire / device sync) inside a held-lock body — the "
             "hung-fsync hostage class utils/watchdog exists for",
    "SY005": "threading.Thread constructed without a reachable join "
             "on the same binding (writer close() discipline)",
    "SY006": "durability-ordering edge violated: a registered "
             "happens-before barrier (analysis/domains.ORDERING_"
             "EDGES) is missing or no longer dominates its guarded "
             "call",
}

_SUPPRESS_RE = re.compile(r"#\s*graftsync:\s*disable=([A-Za-z0-9_,\s]+)")

# method calls that mutate their receiver container in place (SY001's
# and SY003's definition of "mutation" beyond assignment/del)
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "popitem", "remove", "discard", "clear", "update", "add",
    "setdefault", "put", "put_nowait", "move_to_end", "sort",
    "reverse", "write",
})

# SY004's blocking-call sets: plain dotted calls, and method attrs.
# `put` only counts on a queue-shaped receiver (see _queue_like);
# `put_nowait` and condition `.wait()` are deliberately absent (non-
# blocking / the cv idiom).
_BLOCKING_CALLS = frozenset({
    "os.fsync", "fsync", "os.replace", "os.rename", "time.sleep",
})
_BLOCKING_METHODS = frozenset({
    "join", "acquire", "block_until_ready", "gather_host", "drain",
    "drain_queue", "result", "synchronize",
})
_QUEUE_NAME_RE = re.compile(r"(^|_)q(ueue)?s?$|queue", re.IGNORECASE)

# sinks whose callable argument runs on another thread (SY001's
# thread-entry detection): Thread(target=...), and the bounded-queue
# writers' submit(job)
_SUBMIT_METHODS = frozenset({"submit"})


def _suppressions(source: str) -> Dict[int, set]:
    return suppressions(source, _SUPPRESS_RE)


class SyncModule:
    """One parsed file plus the derived facts the SY rules share."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node

    def enclosing(self, node: ast.AST, kinds) -> Iterator[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, kinds):
                yield cur
            cur = self.parents.get(cur)

    def enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        return next(self.enclosing(node, ast.ClassDef), None)

    def enclosing_function(self, node: ast.AST):
        return next(self.enclosing(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)),
            None)


# ---------------------------------------------------------------------------
# shared chain helpers


def _self_root_attr(expr: ast.AST) -> Optional[str]:
    """`self.a`, `self.a.b`, `self.a[k]`, `self.a[k].c` -> 'a';
    None when the chain is not rooted at `self`."""
    chain: List[Optional[str]] = []
    cur = expr
    while isinstance(cur, (ast.Attribute, ast.Subscript)):
        chain.append(cur.attr if isinstance(cur, ast.Attribute)
                     else None)
        cur = cur.value
    if isinstance(cur, ast.Name) and cur.id == "self":
        for attr in reversed(chain):
            return attr  # the attribute directly on self
    return None


def _root_name(expr: ast.AST) -> Tuple[Optional[str], int]:
    """(root Name id, chain depth) of an attribute/subscript chain:
    `x[k].a` -> ('x', 2); a bare `x` -> ('x', 0)."""
    depth = 0
    cur = expr
    while isinstance(cur, (ast.Attribute, ast.Subscript)):
        depth += 1
        cur = cur.value
    if isinstance(cur, ast.Name):
        return cur.id, depth
    return None, depth


def _mutations(scope: ast.AST) -> Iterator[Tuple[ast.AST, ast.expr]]:
    """(site node, mutated target chain) pairs inside `scope`:
    assignments, augmented assignments, deletes, and in-place mutator
    method calls. The caller classifies the chain (self-rooted vs
    local name)."""
    def _expand(tgt: ast.expr) -> Iterator[ast.expr]:
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for elt in tgt.elts:
                yield from _expand(elt)
        elif isinstance(tgt, ast.Starred):
            yield from _expand(tgt.value)
        else:
            yield tgt

    for node in ast.walk(scope):
        if isinstance(node, ast.Assign):
            for raw in node.targets:
                for tgt in _expand(raw):
                    yield node, tgt
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if getattr(node, "value", None) is None:
                continue
            yield node, node.target
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                yield node, tgt
        elif (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _MUTATORS):
            yield node, node.func.value


def _with_lock_items(node: ast.AST) -> List[ast.expr]:
    """The lock-like context expressions of a With node (see
    _is_lock_expr), or []."""
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return []
    return [item.context_expr for item in node.items
            if _is_lock_expr(item.context_expr)]


def _is_lock_expr(expr: ast.expr) -> bool:
    """Heuristic lock detection for `with X:` — a plain Name/Attribute
    chain whose terminal contains 'lock' or names a Condition
    (`all_tasks_done`, `*_cv`, `*cond*`). Precision over recall: a
    lock held through an exotic alias is invisible, but everything
    this repo's writers do is covered, and false positives stay
    zero."""
    name = _dotted(expr)
    if not name:
        return False
    term = _terminal(name).lower()
    return ("lock" in term or term == "all_tasks_done"
            or term.endswith("_cv") or "cond" in term)


def _lock_identity(module: SyncModule, expr: ast.expr) -> str:
    """Stable identity for a lock expression: class-qualified for
    self-rooted attributes, the dotted source chain otherwise."""
    attr = _self_root_attr(expr)
    if attr is not None:
        cls = module.enclosing_class(expr)
        return f"{cls.name}.{attr}" if cls else f"self.{attr}"
    return _dotted(expr) or "<lock>"


def _held_locks(module: SyncModule, node: ast.AST) -> List[ast.expr]:
    """Lock expressions held (lexically) at `node`, outermost first —
    every enclosing `with <lock>:` item. The walk stops at function
    boundaries: a nested def's BODY does not run under the
    enclosing with (it merely closes over it)."""
    out: List[ast.expr] = []
    cur = module.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            break
        for item in _with_lock_items(cur):
            out.append(item)
        cur = module.parents.get(cur)
    out.reverse()
    return out


# ---------------------------------------------------------------------------
# SY001 — shared-state guard discipline


def _thread_entry_functions(module: SyncModule) -> Set[ast.AST]:
    """Function/lambda nodes whose body runs on another thread:
    Thread(target=...) targets, closures handed to a writer's
    .submit(), and everything those reach through same-class
    `self.method()` calls."""
    entry_names: Set[str] = set()
    entry_nodes: Set[ast.AST] = set()
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        if _terminal(_dotted(node.func)) == "Thread":
            tgt = next((kw.value for kw in node.keywords
                        if kw.arg == "target"), None)
            if tgt is None and node.args:
                tgt = node.args[0]
            if isinstance(tgt, ast.Lambda):
                entry_nodes.add(tgt)
            elif tgt is not None:
                name = _terminal(_dotted(tgt))
                if name:
                    entry_names.add(name)
        elif (isinstance(node.func, ast.Attribute)
                and node.func.attr in _SUBMIT_METHODS):
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(a, ast.Lambda):
                    entry_nodes.add(a)
                elif isinstance(a, ast.Name):
                    entry_names.add(a.id)
    # resolve names to defs (methods or nested functions), then close
    # over the same-class `self.m()` call graph
    by_name: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, []).append(node)
    work = [fn for name in entry_names for fn in by_name.get(name, ())]
    entry_nodes.update(work)
    while work:
        fn = work.pop()
        cls = module.enclosing_class(fn)
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "self"):
                continue
            for callee in by_name.get(node.func.attr, ()):
                if (callee not in entry_nodes
                        and module.enclosing_class(callee) is cls):
                    entry_nodes.add(callee)
                    work.append(callee)
    return entry_nodes


def _owning_function(module: SyncModule, node: ast.AST):
    return module.enclosing_function(node)


def _in_thread_domain(module: SyncModule, node: ast.AST,
                      entries: Set[ast.AST]) -> bool:
    """True when `node` sits lexically inside a thread-entry function
    (including nested defs of one)."""
    if node in entries:
        return True
    return any(fn in entries for fn in module.enclosing(
        node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))


def _under_guard(module: SyncModule, node: ast.AST,
                 guard: str) -> bool:
    # _held_locks is function-bounded: a nested def's body does not
    # hold the lock its enclosing function's `with` took
    return any(_self_root_attr(expr) == guard
               for expr in _held_locks(module, node))


def check_sy001(module: SyncModule) -> Iterator[Violation]:
    entries = _thread_entry_functions(module)
    for cls in (n for n in ast.walk(module.tree)
                if isinstance(n, ast.ClassDef)):
        # mutation sites per attribute: (site, in __init__?, thread?)
        sites: Dict[str, List[Tuple[ast.AST, bool, bool]]] = {}
        for site, target in _mutations(cls):
            if module.enclosing_class(target) is not cls:
                continue  # a nested class owns its own discipline
            attr = _self_root_attr(target)
            if attr is None:
                continue
            fn = _owning_function(module, site)
            in_init = (isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                       and fn.name == "__init__"
                       and module.enclosing_class(fn) is cls)
            sites.setdefault(attr, []).append(
                (site, in_init, _in_thread_domain(module, site,
                                                 entries)))
        for attr, hits in sorted(sites.items()):
            key = f"{cls.name}.{attr}"
            guard = SHARED_STATE.get(key)
            if guard is not None:
                for site, in_init, _ in hits:
                    if in_init:
                        continue  # construction precedes concurrency
                    if not _under_guard(module, site, guard):
                        yield Violation(
                            module.path, site.lineno, site.col_offset,
                            "SY001",
                            f"`self.{attr}` is registered shared "
                            f"state (SHARED_STATE[{key!r}]) but this "
                            f"mutation is not under `with "
                            f"self.{guard}:` — another thread can "
                            "observe a torn update; take the guard "
                            "or (if provably single-threaded here) "
                            "suppress with a justification")
                continue
            live = [(s, t) for s, init, t in hits if not init]
            if (any(t for _, t in live)
                    and any(not t for _, t in live)):
                for site, _ in live:
                    yield Violation(
                        module.path, site.lineno, site.col_offset,
                        "SY001",
                        f"`self.{attr}` is mutated both from a "
                        "thread-entry function and from outside one "
                        f"but `{key}` is not in the shared-state "
                        "registry: declare it (with its guard lock) "
                        "in analysis/domains.SHARED_STATE so the "
                        "guard discipline is enforced, or move the "
                        "mutation onto one thread")


# ---------------------------------------------------------------------------
# SY002 — static lock-order graph

# edge: (outer identity, inner identity) -> first acquisition site
LockEdges = Dict[Tuple[str, str], Tuple[str, int, int]]


def lock_order_edges(module: SyncModule) -> LockEdges:
    edges: LockEdges = {}
    for node in ast.walk(module.tree):
        inner_locks = _with_lock_items(node)
        explicit = None
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "acquire"
                and _is_lock_expr(node.func.value)):
            explicit = node.func.value
        if not inner_locks and explicit is None:
            continue
        held = _held_locks(module, node)
        held_ids = [_lock_identity(module, h) for h in held]
        # `with a, b:` — a is held when b is acquired
        acquired = list(inner_locks)
        if explicit is not None:
            acquired.append(explicit)
        for i, expr in enumerate(acquired):
            inner_id = _lock_identity(module, expr)
            outers = held_ids + [_lock_identity(module, e)
                                 for e in inner_locks[:i]]
            for outer_id in outers:
                if outer_id == inner_id:
                    continue  # re-entrant acquire, no ordering edge
                edges.setdefault(
                    (outer_id, inner_id),
                    (module.path, expr.lineno, expr.col_offset))
    return edges


def sy002_findings(all_edges: LockEdges) -> List[Violation]:
    out: List[Violation] = []
    for cyc in find_cycles(edges_to_graph(all_edges)):
        sites = []
        for a, b in zip(cyc, cyc[1:]):
            path, line, col = all_edges[(a, b)]
            sites.append(f"{a} -> {b} at {path}:{line}")
        path, line, col = all_edges[(cyc[0], cyc[1])]
        out.append(Violation(
            path, line, col, "SY002",
            "static lock-acquisition-order cycle "
            f"{' -> '.join(cyc)} — two threads taking these locks in "
            "their written orders deadlock (ABBA); pick ONE global "
            f"order. Acquisition sites: {'; '.join(sites)}"))
    return out


# ---------------------------------------------------------------------------
# SY003 — producer-side mutation after enqueue


def check_sy003(module: SyncModule) -> Iterator[Violation]:
    funcs = [n for n in ast.walk(module.tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for fn in funcs:
        # events in source order within THIS function (nested defs
        # excluded: they are their own scope and typically ARE the
        # enqueued job)
        events: List[Tuple[int, int, str, str, ast.AST]] = []
        stack = list(fn.body)
        while stack:
            node = stack.pop()
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)):
                continue
            stack.extend(ast.iter_child_nodes(node))
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("put", "put_nowait",
                                           "submit")
                    and node.args
                    and isinstance(node.args[0], ast.Name)):
                events.append((node.lineno, node.col_offset, "enq",
                               node.args[0].id, node))
            elif isinstance(node, ast.Assign):
                flat: List[ast.expr] = []
                work = list(node.targets)
                while work:
                    tgt = work.pop()
                    if isinstance(tgt, (ast.Tuple, ast.List)):
                        work.extend(tgt.elts)
                    elif isinstance(tgt, ast.Starred):
                        work.append(tgt.value)
                    else:
                        flat.append(tgt)
                for tgt in flat:
                    if isinstance(tgt, ast.Name):
                        events.append((node.lineno, node.col_offset,
                                       "rebind", tgt.id, node))
                    else:
                        name, depth = _root_name(tgt)
                        if name and depth:
                            events.append((node.lineno,
                                           node.col_offset, "mut",
                                           name, node))
            elif isinstance(node, ast.AugAssign):
                name, depth = _root_name(node.target)
                if name:
                    events.append((node.lineno, node.col_offset,
                                   "mut", name, node))
            elif isinstance(node, ast.Delete):
                for tgt in node.targets:
                    name, depth = _root_name(tgt)
                    if name and depth:
                        events.append((node.lineno, node.col_offset,
                                       "mut", name, node))
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MUTATORS):
                name, _ = _root_name(node.func.value)
                if name:
                    events.append((node.lineno, node.col_offset,
                                   "mut", name, node))
        enqueued: Dict[str, int] = {}
        for lineno, col, kind, name, node in sorted(
                events, key=lambda e: (e[0], e[1])):
            if kind == "enq":
                enqueued[name] = lineno
            elif kind == "rebind":
                enqueued.pop(name, None)
            elif kind == "mut" and name in enqueued:
                yield Violation(
                    module.path, lineno, col, "SY003",
                    f"`{name}` was handed to a writer queue at line "
                    f"{enqueued[name]} and is mutated afterwards on "
                    "the producer side: the drain loop may be "
                    "reading it concurrently (torn record). "
                    "Serialize/copy before enqueue (the journal's "
                    "producer-side-serialize contract) or rebind a "
                    "fresh value")


# ---------------------------------------------------------------------------
# SY004 — blocking call under a held lock


def _queue_like(expr: ast.AST) -> bool:
    name = _dotted(expr)
    if not name:
        return False
    return bool(_QUEUE_NAME_RE.search(_terminal(name)))


def check_sy004(module: SyncModule) -> Iterator[Violation]:
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        held = _held_locks(module, node)
        if not held:
            continue
        name = _dotted(node.func)
        what = None
        if name in _BLOCKING_CALLS:
            what = f"`{name}()`"
        elif isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr in _BLOCKING_METHODS:
                # the condition-variable idiom: waiting/acquiring ON
                # the very object you hold is how Condition works
                recv = _dotted(node.func.value)
                held_names = {_dotted(h) for h in held}
                if not (attr == "acquire" and recv in held_names):
                    what = f"`.{attr}()`"
            elif attr == "put" and _queue_like(node.func.value):
                what = "a blocking queue `.put()`"
        if what is None:
            continue
        locks = ", ".join(_lock_identity(module, h) for h in held)
        yield Violation(
            module.path, node.lineno, node.col_offset, "SY004",
            f"{what} while holding {locks}: a slow or hung operation "
            "(dead NFS fsync, a full bounded queue) here blocks every "
            "other user of the lock — the hostage class "
            "utils/watchdog exists for. Move the blocking work "
            "outside the critical section (capture under the lock, "
            "write outside it)")


# ---------------------------------------------------------------------------
# SY005 — thread lifecycle (construct => join)


def check_sy005(module: SyncModule) -> Iterator[Violation]:
    joins: Set[str] = set()
    for node in ast.walk(module.tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"):
            name = _dotted(node.func.value)
            if name:
                joins.add(_terminal(name))
    for node in ast.walk(module.tree):
        if not (isinstance(node, ast.Call)
                and _dotted(node.func) in ("threading.Thread",
                                           "Thread")):
            continue
        parent = module.parents.get(node)
        binding = None
        targets: List[ast.expr] = []
        if isinstance(parent, ast.Assign):
            targets = list(parent.targets)
        elif isinstance(parent, ast.AnnAssign):
            targets = [parent.target]
        for tgt in targets:
            attr = _self_root_attr(tgt)
            if attr is not None:
                binding = attr
            elif isinstance(tgt, ast.Name):
                binding = tgt.id
        if binding is not None and binding in joins:
            continue
        where = (f"binding `{binding}` is never .join()ed"
                 if binding is not None
                 else "the Thread is never bound, so it can never be "
                      "joined")
        yield Violation(
            module.path, node.lineno, node.col_offset, "SY005",
            f"threading.Thread constructed but {where} in this file: "
            "without a close()-path join the thread dies mid-write at "
            "interpreter exit (for a writer queue that is LOST "
            "state); keep the handle and join it on the close/finally "
            "path (the AsyncCheckpointWriter.close discipline)")


# ---------------------------------------------------------------------------
# SY006 — durability-ordering dominance


def _function_named(tree: ast.Module, name: str):
    for node in ast.walk(tree):
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name == name):
            return node
    return None


def _own_body_nodes(fn: ast.AST) -> Iterator[ast.AST]:
    """Nodes in `fn`'s OWN body — nested def/lambda bodies pruned. A
    barrier moved into a closure (called conditionally, or not at
    all) does not dominate anything at runtime, so SY006 must not
    count it; same scoping rule as SY003."""
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def ordering_findings(files: Dict[str, Tuple[str, ast.Module]],
                      edges: Optional[dict] = None
                      ) -> List[Violation]:
    """SY006 over a {normalized path: (source, tree)} map. Exposed
    separately so tests can prove the delete-a-barrier-turns-red
    property on SCRATCH COPIES of the registered functions (fixture
    source) without mutating the tree."""
    edges = ORDERING_EDGES if edges is None else edges
    out: List[Violation] = []
    for name, edge in sorted(edges.items()):
        target = edge["path"].replace(os.sep, "/")
        match = next((p for p in sorted(files)
                      if p.endswith(target) or target.endswith(p)),
                     None)
        if match is None:
            out.append(Violation(
                target, 1, 0, "SY006",
                f"ordering edge `{name}`: registered file {target!r} "
                "was not scanned — the audit paths no longer cover "
                "it, so the contract is unenforced (fix the paths or "
                "re-register the edge)"))
            continue
        source, tree = files[match]
        fn = _function_named(tree, edge["function"])
        if fn is None:
            out.append(Violation(
                match, 1, 0, "SY006",
                f"ordering edge `{name}`: function "
                f"`{edge['function']}` no longer exists in {target} — "
                "the happens-before contract "
                f"(`{edge['before']}` before `{edge['after']}`: "
                f"{edge['why']}) must be re-registered on its new "
                "home, not dropped"))
            continue
        befores: List[int] = []
        afters: List[Tuple[int, int]] = []
        for node in _own_body_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            term = _terminal(_dotted(node.func))
            if term == edge["before"]:
                befores.append(node.lineno)
            elif term == edge["after"]:
                afters.append((node.lineno, node.col_offset))
        if not afters:
            out.append(Violation(
                match, fn.lineno, fn.col_offset, "SY006",
                f"ordering edge `{name}`: `{edge['function']}` no "
                f"longer calls `{edge['after']}` — the guarded "
                "operation moved; move the registered edge with it "
                f"(contract: {edge['why']})"))
            continue
        if not befores:
            out.append(Violation(
                match, fn.lineno, fn.col_offset, "SY006",
                f"ordering edge `{name}`: the `{edge['before']}` "
                f"barrier is GONE from `{edge['function']}` but "
                f"`{edge['after']}` still runs — {edge['why']}"))
            continue
        first_before = min(befores)
        for lineno, col in sorted(afters):
            if lineno < first_before:
                out.append(Violation(
                    match, lineno, col, "SY006",
                    f"ordering edge `{name}`: `{edge['after']}` at "
                    f"line {lineno} runs BEFORE the first "
                    f"`{edge['before']}` barrier (line "
                    f"{first_before}) — {edge['why']}"))
    return out


# ---------------------------------------------------------------------------
# per-file pass + whole-tree audit

_PER_FILE_RULES = {
    "SY001": check_sy001,
    "SY003": check_sy003,
    "SY004": check_sy004,
    "SY005": check_sy005,
}


class SyncLintError(RuntimeError):
    """A file could not be parsed."""


def sync_source(path: str, source: str,
                edges: Optional[dict] = None) -> List[Violation]:
    """Audit ONE file's source (per-file rules SY001/SY003/SY004/
    SY005, the file's own SY002 lock graph, and — when `edges` is
    given — SY006 against just this file). Suppressions applied.
    The test-suite entry point; the CLI uses run_sync_audit."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        raise SyncLintError(f"{path}: syntax error: {e}") from e
    module = SyncModule(path, source, tree)
    suppressed = _suppressions(source)
    out: List[Violation] = []
    for rule, check in _PER_FILE_RULES.items():
        out.extend(check(module))
    out.extend(sy002_findings(lock_order_edges(module)))
    if edges is not None:
        out.extend(ordering_findings(
            {path.replace(os.sep, "/"): (source, tree)}, edges))
    return sorted(set(
        v for v in out if v.rule not in suppressed.get(v.line, ())))


def run_sync_audit(paths: Sequence[str], exclude: Sequence[str] = ()
                   ) -> Tuple[dict, List[Violation]]:
    """(report, findings) over the configured host packages: per-file
    rules + the UNION lock-order graph (SY002 across files — an ABBA
    pair may live in two modules) + the SY006 ordering registry."""
    findings: List[Violation] = []
    all_edges: LockEdges = {}
    parsed: Dict[str, Tuple[str, ast.Module]] = {}
    suppressed_by_path: Dict[str, Dict[int, set]] = {}
    for path in iter_python_files(paths, exclude):
        with open(path, encoding="utf-8") as f:
            source = f.read()
        rel = os.path.relpath(path).replace(os.sep, "/")
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            raise SyncLintError(f"{rel}: syntax error: {e}") from e
        module = SyncModule(rel, source, tree)
        suppressed_by_path[rel] = _suppressions(source)
        parsed[rel] = (source, tree)
        for rule, check in _PER_FILE_RULES.items():
            findings.extend(check(module))
        for key, site in lock_order_edges(module).items():
            all_edges.setdefault(key, site)
    findings.extend(sy002_findings(all_edges))
    findings.extend(ordering_findings(parsed))
    findings = sorted(set(
        v for v in findings
        if v.rule not in suppressed_by_path.get(v.path, {}).get(
            v.line, ())))
    by_file: Dict[str, Dict[str, int]] = {}
    rules: Dict[str, int] = {r: 0 for r in SYNC_RULE_DOCS}
    for v in findings:
        rules[v.rule] = rules.get(v.rule, 0) + 1
        by_file.setdefault(v.path, {}).setdefault(v.rule, 0)
        by_file[v.path][v.rule] += 1
    report = {
        "version": 1,
        "files_scanned": len(parsed),
        "rules": rules,
        "by_file": {p: dict(sorted(c.items()))
                    for p, c in sorted(by_file.items())},
        "registry": {"shared_state": len(SHARED_STATE),
                     "ordering_edges": len(ORDERING_EDGES),
                     "lock_order_edges": len(all_edges)},
    }
    report["digest"] = report_digest(report)
    return report, findings


def report_digest(report: dict) -> str:
    """sha256 over the canonical finding/registry counts — the
    bit-identical-across-runs claim is checked on exactly this value
    (same contract as graftaudit's report_digest)."""
    canon = json.dumps({"rules": report["rules"],
                        "by_file": report["by_file"],
                        "registry": report["registry"]},
                       sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canon.encode()).hexdigest()


def journal_digest(journal_path: str, report: dict,
                   findings_count: int) -> dict:
    """Append the audit's report to a run journal as a
    `sync_audit_digest` event (schema checked by telemetry.journal.
    validate_journal / scripts/journal_summary.py, mirroring
    audit_digest / mesh_audit_digest)."""
    from commefficient_tpu_torch.telemetry.journal import append_event
    return append_event(
        journal_path, "sync_audit_digest",
        digest=report["digest"],
        rules=report["rules"],
        registry=report["registry"],
        findings=int(findings_count))


# ---------------------------------------------------------------------------
# CLI

DEFAULT_PATHS = [
    "commefficient_tpu_torch/telemetry",
    "commefficient_tpu_torch/utils",
    "commefficient_tpu_torch/federated",
    "commefficient_tpu_torch/parallel",
    "commefficient_tpu_torch/training",
    "commefficient_tpu_torch/scheduler",
    "commefficient_tpu_torch/control",
]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftsync",
        description="static concurrency & durability-ordering audit of "
                    "the port's host packages (rules SY001-SY006; see "
                    "--list-rules). Exit codes: 0 clean, 1 rule "
                    "violations, 3 no such path.")
    ap.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                    help="files/directories to audit (run from the repo "
                         "root for the defaults)")
    ap.add_argument("--journal", default="",
                    help="append the report to this JSONL run journal "
                         "as a `sync_audit_digest` event")
    ap.add_argument("--report", action="store_true",
                    help="print the full JSON report to stdout")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code, doc in sorted(SYNC_RULE_DOCS.items()):
            print(f"{code}  {doc}")
        return 0
    for p in args.paths:
        if not os.path.exists(p):
            print(f"graftsync: no such path: {p}", file=sys.stderr)
            return 3
    try:
        report, findings = run_sync_audit(args.paths)
    except SyncLintError as e:
        print(f"graftsync: {e}", file=sys.stderr)
        return 1
    if args.report:
        print(json.dumps(report, indent=2, sort_keys=True))
    if args.journal:
        journal_digest(args.journal, report, len(findings))
    for v in findings:
        print(v.render())
    if findings:
        print(f"graftsync: {len(findings)} violation(s)")
        return 1
    print(f"graftsync: clean ({report['files_scanned']} file(s), "
          f"{report['registry']['shared_state']} guarded attr(s), "
          f"{report['registry']['ordering_edges']} ordering edge(s), "
          f"digest {report['digest'][:12]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
