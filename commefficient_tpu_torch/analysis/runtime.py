"""Runtime sanitizers, the port of commefficient_tpu/analysis/runtime.py
for host code: what the static passes cannot prove, checked while a
run executes.

  * `LockOrderSanitizer`: graftsync's runtime twin. Installed, it
    replaces `threading.Lock` / `threading.RLock` with recording
    proxies: every acquisition while other instrumented locks are held
    on the same thread adds an edge, and `assert_acyclic()` raises
    `LockOrderError` naming the cycle when two threads ever took locks
    in opposite orders (an ABBA deadlock that only needs worse timing).
    Nodes are lock OBJECTS (their creation site and a serial), so an
    RLock re-entry adds no edge and two queues' mutexes never alias.
    Only locks built after `install()` are instrumented: build the model
    and its writers inside it. `queue.Queue` and `threading.Condition`
    look the factories up when they are built, so the writers' queues
    are instrumented too.
  * `interleaving_stress()`: a deterministic (counter-driven, never
    random) stagger of every `queue.Queue.put` / `get`, which widens the
    producer/drain windows of the bounded-queue writers and the staging
    thread; restored on exit.
  * `NumericSanitizer`: graftnum's runtime twin. Installed, it wraps
    `telemetry.metrics.named`, the one host boundary every exported
    round-metric vector crosses, so a NaN/inf raises `NumericError`
    naming the metric. `.checked` counts the guarded vectors: the port
    calls `named` only from the telemetry session (TelemetrySession's
    round and span emits), so the guard sees traffic only when
    telemetry is on, and a zero after a run means it saw nothing.
    `assert_finite` walks tensors, arrays and nested containers;
    `replay_drill(fn, *args)` runs `fn` twice on the same operands and
    compares every tensor's bytes (after a torch.cuda.synchronize()
    when a card is in use).

  * `forbid_transfers(device)`: the implicit-sync guard behind
    --debug_transfer_guard, the counterpart of JAX's
    `jax.transfer_guard("disallow")`. A `TorchDispatchMode` that raises
    `TransferGuardError`, naming the op and the caller's frame, on an
    IMPLICIT device-to-host synchronisation (`sync_kind`): a scalar
    read (`.item()`, `float()`, `int()`, `bool()`, `if t:`:
    `aten._local_scalar_dense`), a blocking CUDA-to-CPU `_to_copy` or
    `copy_`, and the ops whose output shape depends on the data
    (`nonzero`, `masked_select`, boolean-mask indexing, `unique`,
    `repeat_interleave` without `output_size`). `explicit_transfer(
    reason)` marks a deliberate host boundary (JAX's explicit
    device_get); the guard lets it pass and counts it by reason. CUDA's
    own `torch.cuda.set_sync_debug_mode` is not this guard: it trips on
    the explicit copies too. On a CPU run the guard treats CPU tensors
    as the card's, so the tests exercise it (a CPU copy dispatches
    nothing, so copies show only on the card). A CPU kernel region
    (commefficient_tpu_torch/hooks.py), where a wrapper runs its plain
    version, and a set-up region are exempt; a card wrapper's body is
    not.
  * `count_programs()` / `assert_program_count(n)`: the counterpart of
    the JAX program counter. The port compiles nothing a round, so a
    "program" is a distinct op-signature sequence a train round
    dispatches (`recorder.RoundRecorder.digest` of each
    `hooks.program()` scope inside the block), and every nvcc build
    inside the block counts as one more. The JAX contract of three
    round programs (mask-free, dropout, dropout + stragglers) reads:
    rounds of one variant dispatch the same sequence, and the three
    variants give three.
"""
from __future__ import annotations

import contextlib
import itertools
import math
import queue as _queue
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from commefficient_tpu_torch import hooks
from commefficient_tpu_torch.analysis import recorder as _rec
from commefficient_tpu_torch.analysis.engine import (
    edges_to_graph, find_cycles,
)

# ---------------------------------------------------------------------------
# LockOrderSanitizer


class LockOrderError(AssertionError):
    """The observed lock-acquisition graph has a cycle: two threads took
    instrumented locks in opposite orders at least once."""


class _SanitizedLock:
    """Proxy of a real Lock/RLock that reports acquisitions to its
    sanitizer. Other attributes (RLock's `_release_save` /
    `_acquire_restore` / `_is_owned`, which Condition uses) delegate to
    the wrapped lock, so Condition's wait drives the real lock."""

    def __init__(self, san: "LockOrderSanitizer", inner, node: str):
        self._san = san
        self._inner = inner
        self._node = node

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._san._note_acquire(self)
        return ok

    def release(self) -> None:
        self._san._note_release(self)
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __getattr__(self, name):
        return getattr(self._inner, name)


class LockOrderSanitizer:
    """Record per-thread lock-acquisition edges; assert the graph
    acyclic at teardown. `install()` swaps the factories, `uninstall()`
    restores them and stops recording (proxies already built keep
    working). Usable as a context manager."""

    def __init__(self):
        # a real lock: the sanitizer never instruments its own
        # bookkeeping
        self._graph_lock = threading.Lock()
        # (outer node, inner node) -> (thread name, "file:line" of the
        # inner acquisition)
        self._edges: Dict[Tuple[str, str], Tuple[str, str]] = {}
        self._held = threading.local()
        self._serial = itertools.count()
        self._active = False
        self._orig: Optional[tuple] = None
        self.locks = 0

    @staticmethod
    def _site(depth: int = 2) -> str:
        frame = sys._getframe(depth)
        # out of this module: the node names the caller's site
        while frame is not None and frame.f_globals.get(
                "__name__") == __name__:
            frame = frame.f_back
        if frame is None:
            return "<unknown>"
        return f"{frame.f_code.co_filename}:{frame.f_lineno}"

    def _make(self, ctor):
        def factory():
            node = f"{self._site()}#{next(self._serial)}"
            self.locks += 1
            return _SanitizedLock(self, ctor(), node)
        return factory

    def install(self) -> None:
        if self._orig is not None:
            return
        self._orig = (threading.Lock, threading.RLock)
        threading.Lock = self._make(self._orig[0])
        threading.RLock = self._make(self._orig[1])
        self._active = True

    def uninstall(self) -> None:
        if self._orig is None:
            return
        threading.Lock, threading.RLock = self._orig
        self._orig = None
        self._active = False

    def __enter__(self):
        self.install()
        return self

    def __exit__(self, *exc):
        self.uninstall()
        return False

    def _stack(self) -> List[_SanitizedLock]:
        stack = getattr(self._held, "stack", None)
        if stack is None:
            stack = self._held.stack = []
        return stack

    def _note_acquire(self, lock: _SanitizedLock) -> None:
        stack = self._stack()
        if self._active:
            for held in stack:
                if held is lock:
                    continue  # RLock re-entry: no self-edge
                key = (held._node, lock._node)
                if key not in self._edges:
                    with self._graph_lock:
                        self._edges.setdefault(
                            key, (threading.current_thread().name,
                                  self._site(3)))
        stack.append(lock)

    def _note_release(self, lock: _SanitizedLock) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is lock:
                del stack[i]
                return

    def edges(self) -> Dict[Tuple[str, str], Tuple[str, str]]:
        with self._graph_lock:
            return dict(self._edges)

    def find_cycle(self) -> Optional[List[str]]:
        """One cycle of the observed graph, or None (the cycle
        definition of the static SY002 rule: engine.find_cycles)."""
        cycles = find_cycles(edges_to_graph(self.edges()))
        return cycles[0] if cycles else None

    def assert_acyclic(self) -> None:
        cyc = self.find_cycle()
        if cyc is None:
            return
        edges = self.edges()
        sites = []
        for a, b in zip(cyc, cyc[1:]):
            thread, site = edges[(a, b)]
            sites.append(f"  {a} -> {b}  (thread {thread!r} at {site})")
        raise LockOrderError(
            "lock-order cycle observed — two threads acquired these "
            "locks in opposite orders at least once (ABBA deadlock "
            "given worse timing):\n" + "\n".join(sites)
            + "\npick ONE global acquisition order (graftsync SY002 "
            "checks the static `with` nesting; this caught an order "
            "composed at runtime)")


@contextlib.contextmanager
def interleaving_stress(delay: float = 0.0005, period: int = 3):
    """Every `queue.Queue.put` / `get` sleeps `(i % period) * delay`
    first, `i` a shared counter: a replayable, hostile timing that
    leaves the semantics (FIFO order, bounded back-pressure, drain
    completeness) untouched."""
    counter = itertools.count()
    orig_put, orig_get = _queue.Queue.put, _queue.Queue.get

    def put(self, *args, **kwargs):
        time.sleep((next(counter) % period) * delay)
        return orig_put(self, *args, **kwargs)

    def get(self, *args, **kwargs):
        time.sleep((next(counter) % period) * delay)
        return orig_get(self, *args, **kwargs)

    _queue.Queue.put = put
    _queue.Queue.get = get
    try:
        yield
    finally:
        _queue.Queue.put = orig_put
        _queue.Queue.get = orig_get


# ---------------------------------------------------------------------------
# NumericSanitizer


class NumericError(AssertionError):
    """A non-finite value crossed a guarded boundary (an exported round
    metric), or a replay drill's two runs differ bitwise."""


def _leaves(tree) -> list:
    """Tensors, arrays and scalars of nested dicts / lists / tuples, in
    order (dicts by sorted key)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree, key=str) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _bytes(leaf) -> bytes:
    """One leaf's bytes (a tensor's, of any dtype, from the host)."""
    import numpy as np
    if hasattr(leaf, "detach"):
        import torch
        flat = leaf.detach().cpu().contiguous().reshape(-1)
        return flat.view(torch.uint8).numpy().tobytes()
    return np.asarray(leaf).tobytes()


def _nonfinite(leaf) -> Tuple[int, int]:
    """(non-finite elements, elements) of a float leaf; (0, 0) for
    others."""
    import numpy as np
    if hasattr(leaf, "detach"):
        import torch
        if not (leaf.is_floating_point() or leaf.is_complex()):
            return 0, 0
        return int((~torch.isfinite(leaf.detach())).sum()), leaf.numel()
    arr = np.asarray(leaf)
    if arr.dtype.kind not in "fc":
        return 0, 0
    return int((~np.isfinite(arr)).sum()), arr.size


def _synchronize(leaves) -> None:
    import torch
    if any(getattr(x, "is_cuda", False) for x in leaves):
        torch.cuda.synchronize()


class NumericSanitizer:
    """A scoped post-dispatch numeric guard (module docstring)."""

    def __init__(self):
        self._orig = None
        self.checked = 0

    def _guarded(self, orig):
        def named(vec):
            out = orig(vec)
            self.checked += 1
            bad = {k: v for k, v in out.items() if not math.isfinite(v)}
            if bad:
                raise NumericError(
                    "non-finite round metric(s) exported: "
                    + ", ".join(f"{k}={v}" for k, v in sorted(bad.items()))
                    + " — a NaN/inf survived the round's admission "
                    "guards (analysis/runtime.py)")
            return out
        return named

    def install(self) -> None:
        from commefficient_tpu_torch.telemetry import metrics as tmetrics
        if self._orig is not None:
            return
        self._orig = tmetrics.named
        tmetrics.named = self._guarded(self._orig)

    def uninstall(self) -> None:
        from commefficient_tpu_torch.telemetry import metrics as tmetrics
        if self._orig is None:
            return
        tmetrics.named = self._orig
        self._orig = None

    def __enter__(self):
        self.install()
        return self

    def __exit__(self, *exc):
        self.uninstall()
        return False

    @staticmethod
    def assert_finite(tree, where: str = "value") -> None:
        """NumericError if a float leaf of `tree` holds a NaN/inf
        (non-float and empty leaves pass)."""
        for i, leaf in enumerate(_leaves(tree)):
            bad, size = _nonfinite(leaf)
            if bad:
                raise NumericError(
                    f"non-finite values at {where} (leaf {i}): "
                    f"{bad}/{size} element(s) NaN/inf")

    @staticmethod
    def replay_drill(fn, *args, **kwargs):
        """`fn(*args, **kwargs)` twice, every leaf's bytes equal (a
        deterministic NaN replays clean); returns the first result."""
        first = fn(*args, **kwargs)
        second = fn(*args, **kwargs)
        la, lb = _leaves(first), _leaves(second)
        _synchronize(la + lb)
        if len(la) != len(lb):
            raise NumericError(f"replay divergence: {len(la)} leaves, "
                               f"then {len(lb)}")
        for i, (a, b) in enumerate(zip(la, lb)):
            if _bytes(a) != _bytes(b):
                raise NumericError(
                    f"replay divergence: leaf {i} of {len(la)} differs "
                    "bitwise between two runs on identical operands — "
                    "the crash->resume bit-exactness contract does not "
                    "hold for this function")
        return first


# ---------------------------------------------------------------------------
# the implicit-sync guard


explicit_transfer = hooks.explicit_transfer


class TransferGuardError(RuntimeError):
    """An implicit device-to-host synchronisation under
    forbid_transfers()."""


# ops that hand a device value to the host as a Python scalar
SCALAR_READS = frozenset({
    "_local_scalar_dense.default", "is_nonzero.default", "equal.default",
})
# ops whose output shape the host must read from the device
DATA_DEPENDENT = frozenset({
    "nonzero.default", "masked_select.default", "_unique2.default",
    "_unique.default", "unique_dim.default", "unique_consecutive.default",
    "repeat_interleave.Tensor",
})
# indexing ops that take a boolean mask through nonzero on the card
_MASK_INDEX = frozenset({
    "index.Tensor", "index_put_.default", "index_put.default",
    "_index_put_impl_.default",
})


def sync_kind(op: str, ins, scalars, kwargs, device: str
              ) -> Optional[str]:
    """Why the op (its name, input metas (shape, dtype, device), scalar
    and keyword arguments) synchronises `device` ("cuda", or "cpu" for
    the guard's CPU reading) with the host, or None. Shared by the
    guard and graftaudit's AU001."""
    kw = dict(kwargs)
    if not ins:
        return None
    on_dev = ins[0][2] == device
    if op in SCALAR_READS and on_dev:
        return "scalar read"
    if op in DATA_DEPENDENT and on_dev:
        if op == "repeat_interleave.Tensor" and kw.get("output_size"):
            return None
        return "data-dependent output shape"
    if op in _MASK_INDEX and on_dev:
        idx = ins[1:-1] if op != "index.Tensor" else ins[1:]
        if any(m[1] == "bool" for m in idx):
            return "boolean-mask index"
    blocking = not (kw.get("non_blocking") or True in scalars[:1])
    if op == "_to_copy.default" and ins[0][2] == "cuda" \
            and kw.get("device") == "cpu" and blocking:
        return "device-to-host copy"
    if op == "copy_.default" and len(ins) > 1 and ins[0][2] == "cpu" \
            and ins[1][2] == "cuda" and blocking:
        return "device-to-host copy"
    return None


# every op sync_kind can name: the guard looks no further at others
_CANDIDATES = (SCALAR_READS | DATA_DEPENDENT | _MASK_INDEX
               | {"_to_copy.default", "copy_.default"})

def _caller_frame() -> str:
    """file:line (function) of the innermost frame outside torch and
    this package's analysis modules."""
    frame = sys._getframe(1)
    while frame is not None:
        fn = frame.f_code.co_filename.replace("\\", "/")
        if "/torch/" not in fn and "/analysis/" not in fn:
            return (f"{fn}:{frame.f_lineno} "
                    f"({frame.f_code.co_name})")
        frame = frame.f_back
    return "<unknown>"


class TransferGuard:
    """The armed guard: it raises on the first implicit sync, and
    `explicit` counts the passed boundaries by reason."""

    def __init__(self, device="cuda"):
        dev = getattr(device, "type", None) or str(device).split(":")[0]
        self.device = dev if dev in ("cuda", "cpu") else "cuda"
        self.explicit: Dict[str, int] = {}
        self.thread: Optional[int] = None
        self._mode = None

    def check(self, func, args, kwargs) -> None:
        import torch
        op = func.__name__
        if op not in _CANDIDATES:
            return
        ins = tuple(_rec._meta(t) for t in _rec.tensors_of(
            kwargs, _rec.tensors_of(args)))
        scalars = tuple(a for a in args if isinstance(a, (bool, int,
                                                          float)))
        kw = {k: (_rec._scalar(v) if not isinstance(v, torch.Tensor)
                  else None) for k, v in kwargs.items()}
        kind = sync_kind(op, ins, scalars, kw, self.device)
        if kind is None:
            return
        reason = hooks.explicit_reason()
        if reason is not None:
            self.explicit[reason] = self.explicit.get(reason, 0) + 1
            return
        raise TransferGuardError(
            f"implicit device-to-host sync under forbid_transfers(): "
            f"{kind} `{op}` at {_caller_frame()} — keep the value on the "
            "device, or mark a deliberate host boundary with "
            "explicit_transfer(reason)")

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        guard = self

        class _Mode(TorchDispatchMode):
            # the port compiles nothing: no Dynamo guard around the hook,
            # whose first use imports Dynamo (seconds) and which costs each op
            @classmethod
            def _should_skip_dynamo(cls):
                return False

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if not hooks.guard_exempt():
                    guard.check(func, args, kwargs)
                return func(*args, **kwargs)

        self._mode = _Mode()
        self._mode.__enter__()
        hooks.arm(self)
        return self

    def __exit__(self, *exc):
        hooks.disarm(self)
        self._mode.__exit__(*exc)
        self._mode = None
        return False


def forbid_transfers(device="cuda") -> TransferGuard:
    """The guard over the block (module docstring); `device` is the
    model's ("cpu" for the guard's CPU reading)."""
    return TransferGuard(device)


# ---------------------------------------------------------------------------
# the program counter


class ProgramCount:
    """`count_programs`' handle: `.count` is the distinct round
    programs seen plus the nvcc builds, live during the block;
    `.digests` the program digests in order of first sight."""

    def __init__(self):
        from commefficient_tpu_torch.ops.kernels import _build
        self._build = _build
        self._builds0 = _build.BUILDS["nvcc"]
        self.digests: List[str] = []
        self.rounds = 0
        self.thread: Optional[int] = None

    def on_program(self, digest: str) -> None:
        self.rounds += 1
        if digest not in self.digests:
            self.digests.append(digest)

    @property
    def builds(self) -> int:
        return self._build.BUILDS["nvcc"] - self._builds0

    @property
    def count(self) -> int:
        return len(self.digests) + self.builds


@contextlib.contextmanager
def count_programs():
    """Count the distinct round programs (and nvcc builds) inside the
    block."""
    c = ProgramCount()
    hooks.arm(c)
    try:
        yield c
    finally:
        hooks.disarm(c)


@contextlib.contextmanager
def assert_program_count(n: int):
    """Assert EXACTLY `n` programs inside the block (count_programs)."""
    with count_programs() as c:
        yield c
    got = c.count
    if got != n:
        why = ("an extra program means a round dispatched an op sequence "
               "(op, shapes, dtypes) none before it did, or a kernel was "
               "built inside the block" if got > n else
               "fewer means fewer variants ran than the contract names")
        raise AssertionError(
            f"program-count contract violated: expected exactly {n} "
            f"program(s) in this block, observed {got} ({len(c.digests)} "
            f"op sequence(s) over {c.rounds} round(s), {c.builds} "
            f"build(s)); {why} (see analysis/runtime.py)")
