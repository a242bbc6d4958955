"""graftlint's rules, the port of commefficient_tpu/analysis/rules.py,
every code of the JAX package's with its number.

Each rule is a function ``check(module: ModuleInfo) -> Iterator[
Violation]`` over one parsed file, mechanical and precise rather than
broad: a lint that cries wolf gets disabled, a narrow one stays armed.

The host rules (GL005, GL006, GL009, GL011, GL012, GL014) read host
code, which the port shares with the JAX package in kind (writer
threads, atomic files, PRNG domains, controllers), so on the same
source both packages report the same (rule, line, column).

The JAX package's rules over traced code walk what jax.jit, vmap,
shard_map or lax.scan trace. The port traces nothing; its counterpart
of traced code is the round's path, every line of `federated/round.py`,
`federated/server.py`, `federated/client.py`, `ops/` and `compress/`
(ROUND_PATH), where a host sync stalls every round:

  GL001  host clocks or unseeded global RNG on the round's path
  GL002  `.item()`, `.cpu()`, `.numpy()`, `.tolist()`, or float() / int()
         / bool() of a tensor expression: the static twin of the
         implicit-sync guard (analysis/runtime.forbid_transfers)
  GL003  a threefry key (ops/prng.py) consumed by two draws without a
         fold_in between
  GL004  a Python if / while / for over a tensor value
  GL008  torch.topk with a static k >= GL008_MIN_K, or a sort sliced to
         such a k, outside ops/flat.topk_indices
  GL013  float == / != on tensors (exact-zero sparsity tests legal)

and two read the rank layer, as the JAX ones read the sharding layer:

  GL007  a raw torch.distributed collective outside parallel/mesh.Layout,
         the ring (parallel/ring.py) and the plan transport
         (parallel/plantransport.py), anywhere in the package
  GL010  an axis-name literal at a Layout call in parallel/ or
         federated/ that is not in analysis/domains.MESH_AXES
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Set, Tuple

from commefficient_tpu_torch.analysis.domains import (
    CONTROL_FIELDS, MESH_AXES,
)
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
# the round's path: the port's traced code

ROUND_PATH = ("federated/round.py", "federated/server.py",
              "federated/client.py", "ops/", "compress/")


def on_round_path(module: ModuleInfo) -> bool:
    path = "/" + module.path.replace(os.sep, "/")
    return any(f"/commefficient_tpu_torch/{p}" in path
               or path.startswith(f"/{p}") for p in ROUND_PATH)


def _round_path_nodes(module: ModuleInfo) -> Iterator[ast.AST]:
    if on_round_path(module):
        yield from ast.walk(module.tree)


# tensor methods that reduce to a value the host would branch on
_TENSOR_REDUCERS = frozenset({"any", "all", "sum", "mean", "max", "min",
                              "prod", "item", "norm", "amax", "amin",
                              "count_nonzero", "numel_nonzero"})


# torch calls that give host values (devices, dtypes, limits) or shape-only
# views whose iteration reads nothing from the device
_HOST_TORCH = frozenset({
    "device", "dtype", "finfo", "iinfo", "promote_types", "is_tensor",
    "is_floating_point", "Size", "get_default_dtype", "split", "unbind",
    "chunk", "are_deterministic_algorithms_enabled", "is_grad_enabled",
})


def _tensor_expr(expr: ast.AST) -> Optional[str]:
    """A sub-expression that clearly produces a tensor: a torch. call, or
    a reducer method on a bare name or computed base (cfg.*, self.* are
    host objects)."""
    for node in ast.walk(expr):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if (name and name.startswith(("torch.", "F."))
                and not name.startswith(("torch.cuda.", "torch.backends."))
                and _terminal(name) not in _HOST_TORCH):
            return name
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _TENSOR_REDUCERS and not node.args):
            base = _dotted(node.func.value)
            if base is None or "." not in base:
                return f".{node.func.attr}()"
    return None


# ---------------------------------------------------------------------------
# GL001 — host nondeterminism on the round's path

_GL001_CLOCKS = frozenset({
    "time.time", "time.time_ns", "time.monotonic", "time.perf_counter",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow",
})
_NP_GLOBAL_DRAWS = frozenset({
    "rand", "randn", "random", "random_sample", "randint", "choice",
    "permutation", "shuffle", "uniform", "normal", "standard_normal",
    "beta", "binomial", "poisson", "exponential", "bytes",
})
_PY_RANDOM_DRAWS = frozenset({
    "random", "randint", "randrange", "choice", "choices", "shuffle",
    "uniform", "gauss", "sample", "betavariate", "getrandbits",
})
_TORCH_GLOBAL_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "rand_like", "randn_like", "randint_like",
})


def check_gl001(module: ModuleInfo) -> Iterator[Violation]:
    for node in _round_path_nodes(module):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if not name:
            continue
        what = None
        if name in _GL001_CLOCKS or name.endswith(".datetime.now"):
            what = f"host clock `{name}()`"
        elif (name.startswith(("np.random.", "numpy.random."))
              and _terminal(name) in _NP_GLOBAL_DRAWS):
            what = f"unseeded global-state draw `{name}()`"
        elif (name.startswith("random.")
              and _terminal(name) in _PY_RANDOM_DRAWS):
            what = f"unseeded `{name}()`"
        elif (name.startswith("torch.")
              and _terminal(name) in _TORCH_GLOBAL_DRAWS
              and not any(kw.arg == "generator" for kw in node.keywords)):
            what = f"global-generator draw `{name}()`"
        if what:
            yield Violation(
                module.path, node.lineno, node.col_offset, "GL001",
                f"{what} on the round's path: the round stops being a pure "
                "function of (state, seed, round), so a resumed replay "
                "diverges; draw from the seeded threefry key (ops/prng.py) "
                "or a seeded generator passed in")


# ---------------------------------------------------------------------------
# GL002 — host syncs on the round's path: the guard's static twin

_GL002_METHODS = frozenset({"item", "cpu", "numpy", "tolist"})


def check_gl002(module: ModuleInfo) -> Iterator[Violation]:
    for node in _round_path_nodes(module):
        if not isinstance(node, ast.Call):
            continue
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _GL002_METHODS and not node.args
                and not node.keywords):
            yield Violation(
                module.path, node.lineno, node.col_offset, "GL002",
                f"`.{node.func.attr}()` on the round's path: a tensor on "
                "the card comes to the host and the host waits for the "
                "round (the implicit sync forbid_transfers raises on); "
                "keep the value on the device, or copy it one round late "
                "under explicit_transfer(reason)")
        elif (isinstance(node.func, ast.Name)
              and node.func.id in ("float", "int", "bool")
              and len(node.args) == 1 and _tensor_expr(node.args[0])):
            yield Violation(
                module.path, node.lineno, node.col_offset, "GL002",
                f"`{node.func.id}(...)` of a tensor expression on the "
                "round's path: a scalar read, the host waits for the "
                "card; keep it a tensor (torch.where) or hoist it out of "
                "the round")


# ---------------------------------------------------------------------------
# GL003 — a threefry key consumed twice

_PRNG_DRAWS = frozenset({"normal", "uniform", "random_bits", "dp_noise"})
_PRNG_MODULE = "commefficient_tpu_torch.ops.prng"


def _prng_names(tree: ast.Module) -> Tuple[Set[str], Set[str]]:
    """(local names bound to ops/prng draws, local names of the prng
    module) from the file's imports; inside ops/prng.py itself its own
    draws."""
    draws: Set[str] = set()
    mods: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == _PRNG_MODULE:
                draws.update(a.asname or a.name for a in node.names
                             if a.name in _PRNG_DRAWS)
            elif node.module == "commefficient_tpu_torch.ops":
                mods.update(a.asname or a.name for a in node.names
                            if a.name == "prng")
            elif node.module == "commefficient_tpu_torch.ops.flat":
                draws.update(a.asname or a.name for a in node.names
                             if a.name == "dp_noise")
    return draws, mods


def check_gl003(module: ModuleInfo) -> Iterator[Violation]:
    draws, mods = _prng_names(module.tree)
    if module.path.replace(os.sep, "/").endswith("ops/prng.py"):
        draws |= {"normal", "uniform", "random_bits"}
    if not draws and not mods:
        return

    def is_draw(call: ast.Call) -> bool:
        name = _dotted(call.func)
        if name in draws:
            return True
        return (name is not None and "." in name
                and name.rsplit(".", 1)[0] in mods
                and _terminal(name) in _PRNG_DRAWS)

    for fn in ast.walk(module.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        events: List[Tuple[int, int, str, str]] = []
        for node in ast.walk(fn):
            owner = next((f for f in module.enclosing_functions(node)
                          if not isinstance(f, ast.Lambda)), None)
            if node is fn or owner is not fn:
                continue
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    for n in ast.walk(tgt):
                        if isinstance(n, ast.Name):
                            events.append((node.lineno, node.col_offset,
                                           "assign", n.id))
            elif isinstance(node, ast.Call) and is_draw(node):
                key = node.args[0] if node.args else next(
                    (kw.value for kw in node.keywords if kw.arg == "key"),
                    None)
                if isinstance(key, ast.Name):
                    events.append((node.lineno, node.col_offset, "draw",
                                   key.id))
        drawn: Set[str] = set()
        for lineno, col, kind, name in sorted(events):
            if kind == "assign":
                drawn.discard(name)
            elif name in drawn:
                yield Violation(
                    module.path, lineno, col, "GL003",
                    f"threefry key `{name}` consumed by a second draw "
                    "without a fold_in between: the two draws are the same "
                    "bits (perfectly correlated noise); fold_in a distinct "
                    "counter (ops/prng.fold_in) first")
            else:
                drawn.add(name)


# ---------------------------------------------------------------------------
# GL004 — Python control flow over tensor values


def check_gl004(module: ModuleInfo) -> Iterator[Violation]:
    for node in _round_path_nodes(module):
        if isinstance(node, (ast.If, ast.While)):
            hit = _tensor_expr(node.test)
            if hit:
                kind = "if" if isinstance(node, ast.If) else "while"
                yield Violation(
                    module.path, node.lineno, node.col_offset, "GL004",
                    f"Python `{kind}` over a tensor value ({hit}) on the "
                    "round's path: the host reads the value, waiting for "
                    "the card; select with torch.where")
        elif isinstance(node, ast.For):
            hit = _tensor_expr(node.iter)
            if hit:
                yield Violation(
                    module.path, node.lineno, node.col_offset, "GL004",
                    f"Python `for` over a tensor value ({hit}) on the "
                    "round's path: each step reads the device")


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
# GL007 — raw torch.distributed collectives outside the rank layer

_GL007_CALLS = frozenset({
    "all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
    "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "reduce", "gather", "scatter", "send", "recv",
    "isend", "irecv", "barrier", "batch_isend_irecv",
    "broadcast_object_list", "all_gather_object",
})
_GL007_HOMES = ("parallel/mesh.py", "parallel/ring.py",
                "parallel/plantransport.py")


def check_gl007(module: ModuleInfo) -> Iterator[Violation]:
    path = module.path.replace(os.sep, "/")
    if path.endswith(_GL007_HOMES):
        return
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func) or ""
        root, _, term = name.rpartition(".")
        if term in _GL007_CALLS and root in ("dist", "torch.distributed"):
            yield Violation(
                module.path, node.lineno, node.col_offset, "GL007",
                f"raw `{name}(...)` outside parallel/mesh.Layout, the ring "
                "and the plan transport: the collective is invisible to "
                "the layout's stats and graftmesh's link report, and its "
                "group is not the layout's; go through Layout.all_reduce "
                "/ gather")


# ---------------------------------------------------------------------------
# GL008 — exact large-k top-k on the round's path

GL008_MIN_K = 2048


def _big_int(node: Optional[ast.AST]) -> Optional[int]:
    if (isinstance(node, ast.Constant) and isinstance(node.value, int)
            and not isinstance(node.value, bool)
            and node.value >= GL008_MIN_K):
        return node.value
    return None


def check_gl008(module: ModuleInfo) -> Iterator[Violation]:
    for node in _round_path_nodes(module):
        if isinstance(node, ast.Call) and _terminal(_dotted(
                node.func)) == "topk" or (isinstance(node, ast.Call)
                                         and isinstance(node.func,
                                                        ast.Attribute)
                                         and node.func.attr == "topk"):
            k = _big_int(node.args[1] if len(node.args) >= 2 else next(
                (kw.value for kw in node.keywords if kw.arg == "k"), None))
            if k is not None:
                yield Violation(
                    module.path, node.lineno, node.col_offset, "GL008",
                    f"exact `topk` with static k={k} on the round's path: "
                    "a selection network over the operand and an "
                    "unspecified tie order; select by the sampled "
                    "threshold (ops/flat.masked_topk) or take indices from "
                    "ops/flat.topk_indices")
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.slice, ast.Slice)
              and _big_int(node.slice.upper) is not None
              and any(isinstance(n, ast.Call)
                      and _terminal(_dotted(n.func)) == "sort"
                      for n in ast.walk(node.value))):
            fn = next(module.enclosing_functions(node), None)
            if getattr(fn, "name", "") == "topk_indices":
                continue
            yield Violation(
                module.path, node.lineno, node.col_offset, "GL008",
                f"a sort sliced to a static k={node.slice.upper.value} on "
                "the round's path outside ops/flat.topk_indices: a full "
                "sort of the operand for a large top-k")


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
# GL010 — mesh-axis names outside the registry
#
# parallel/ and federated/ name Layout axes by string; a literal that is
# not a MESH_AXES value is a typo or an unregistered axis, which the
# Layout would read as its model group (any axis but `clients`).

_GL010_SCOPES = ("/parallel/", "/federated/")
# Layout method -> the positional slot of its axis argument
_GL010_SINKS = {"all_reduce": 1, "gather": 1, "block": 1, "axis_size": 0,
                "axis_index": 0, "_group": 0, "Layout": 1}


def _string_constants(expr: ast.AST) -> Iterator[ast.Constant]:
    for node in ast.walk(expr):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node


def check_gl010(module: ModuleInfo) -> Iterator[Violation]:
    path = "/" + module.path.replace(os.sep, "/")
    if not any(scope in path for scope in _GL010_SCOPES):
        return
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        slot = _GL010_SINKS.get(_terminal(_dotted(node.func))
                                or getattr(node.func, "attr", ""))
        if slot is None:
            continue
        exprs = node.args[slot:slot + 1] + [
            kw.value for kw in node.keywords
            if kw.arg in ("axis", "axis_names")]
        for expr in exprs:
            for const in _string_constants(expr):
                if const.value in MESH_AXES:
                    continue
                yield Violation(
                    module.path, const.lineno, const.col_offset, "GL010",
                    f"axis name {const.value!r} at a Layout call is not in "
                    "the mesh-axis registry (analysis/domains.MESH_AXES = "
                    f"{MESH_AXES}): the Layout reads any axis but "
                    "`clients` as its model group, so a typo silently "
                    "reduces over the wrong ranks")


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
# GL013 — float equality on tensors on the round's path


def _zero_literal(node: ast.AST) -> bool:
    return (isinstance(node, ast.Constant)
            and isinstance(node.value, (int, float))
            and not isinstance(node.value, bool)
            and float(node.value) == 0.0)


def check_gl013(module: ModuleInfo) -> Iterator[Violation]:
    for node in _round_path_nodes(module):
        if not isinstance(node, ast.Compare):
            continue
        if not all(isinstance(op, (ast.Eq, ast.NotEq)) for op in node.ops):
            continue
        sides = [node.left] + list(node.comparators)
        if any(_zero_literal(s) for s in sides):
            continue    # the exact-zero sparsity / sentinel bit test
        lit = next((s.value for s in sides if isinstance(s, ast.Constant)
                    and isinstance(s.value, float)), None)
        hit = next((h for h in map(_tensor_expr, sides) if h), None)
        if lit is not None:
            yield Violation(
                module.path, node.lineno, node.col_offset, "GL013",
                f"float equality against {lit!r} on the round's path: one "
                "ulp of drift (an all_reduce's order, a kernel's) flips "
                "it, breaking the crash->resume bit-exactness; compare "
                "against exact 0, use an inequality, or torch.isclose "
                "with a stated tolerance")
        elif hit is not None:
            yield Violation(
                module.path, node.lineno, node.col_offset, "GL013",
                f"float `==`/`!=` on a computed tensor ({hit}) on the "
                "round's path: equality of computed floats couples the "
                "logic to summation order; compare against exact 0 or "
                "use an inequality")


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
    "GL001": check_gl001,
    "GL002": check_gl002,
    "GL003": check_gl003,
    "GL004": check_gl004,
    "GL005": check_gl005,
    "GL006": check_gl006,
    "GL007": check_gl007,
    "GL008": check_gl008,
    "GL009": check_gl009,
    "GL010": check_gl010,
    "GL011": check_gl011,
    "GL012": check_gl012,
    "GL013": check_gl013,
    "GL014": check_gl014,
}

# the rules that read host code, shared with the JAX package word for
# word; the others read the round's path and the rank layer
HOST_RULES = ("GL005", "GL006", "GL009", "GL011", "GL012", "GL014")
TRACED_RULES = ("GL001", "GL002", "GL003", "GL004", "GL007", "GL008",
                "GL010", "GL013")

RULE_DOCS = {
    "GL001": "host nondeterminism (clocks, unseeded global RNG) on the "
             "round's path",
    "GL002": ".item() / .cpu() / .numpy() / .tolist() / float() of a "
             "tensor on the round's path (an implicit sync)",
    "GL003": "threefry key consumed by two draws without a fold_in",
    "GL004": "Python if/while/for over a tensor value on the round's "
             "path",
    "GL007": "raw torch.distributed collective outside parallel/mesh."
             "Layout, the ring and the plan transport",
    "GL008": "exact torch.topk (or a sliced sort) with a large static k "
             "on the round's path outside ops/flat.topk_indices",
    "GL010": "axis-name literal at a Layout call (parallel/, federated/) "
             "outside the analysis/domains MESH_AXES registry",
    "GL013": "float ==/!= on tensors on the round's path (non-zero "
             "literal or computed comparand); exact-zero tests stay legal",
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
