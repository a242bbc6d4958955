"""The hooks the round's path opens for the analysis tiers
(commefficient_tpu_torch/analysis: the round recorder, the implicit-sync
guard, the program counter). A leaf module of the stdlib alone: the
round imports it without loading the tiers, and with nothing armed (and,
for `kernel_region`, tracing off) every hook is a shared null context
behind one module-global test.

  * `kernel_region(name, device, shapes, bytes, flops)`: each kernel
    wrapper launches (or runs its plain version) inside one. An armed
    recorder of this thread writes it as ONE kernel entry with the bytes
    and operations its bound counts (PERF.md section 6) and leaves the
    aten ops dispatched inside out of its tally, on either device. The
    transfer guard leaves alone only a CPU region's ops, the plain
    version's host reads: a card wrapper's body stays under the guard.
  * `setup_region()`: one-time work a round may trigger (a cache fill),
    hidden from the recorders and the guard alike, with no entry.
  * `stage(name)`: labels the ops dispatched inside with a round stage
    (`gather`, `round`, `scatter`). The label is process-wide: autograd
    runs a CUDA backward on its own device thread while the round's
    thread waits, and those ops carry the waiting round's stage.
  * `program()`: one train round, for an armed program counter of this
    thread (analysis/runtime.count_programs).
  * `explicit_transfer(reason)`: a deliberate host boundary, whose syncs
    pass the guard and are counted under `reason`.

While the global tracer is on (telemetry/trace.py) and torch's profiler
records in this process, each kernel region is also a `kernel.<name>`
range on the profiler's clock, on whichever thread enters it (autograd's
too, where `--remat`'s recompute runs): `profiler_range` below.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Tuple

_LOCAL = threading.local()
# armed recorders, guards and program counters, of any thread; each has
# `.thread`
OBSERVERS: list = []
_STAGE = {"name": None}
_NULL = contextlib.nullcontext()
# kernel regions open `kernel.<name>` profiler ranges (kernel_ranges)
_KERNEL_RANGES = False
# kernel_region's one test: an observer armed or kernel ranges on
_ACTIVE = False
# torch's (profiler probe, range factory), or None without torch: filled
# at the first profiler_range call, so this module imports without torch
_PROFILER: list = []


def profiler_range(name: str):
    """A range named `name` on torch's profiler's clock, to enter and
    exit, while the profiler records in this process; else (or without
    torch) None. The range is `torch._C._profiler._RecordFunctionFast`,
    which a TorchDispatchMode (the round recorder) does not see, where
    `torch.profiler.record_function` dispatches two ops it would
    record."""
    if not _PROFILER:
        try:
            import torch
            _PROFILER.append((torch.autograd._profiler_enabled,
                              torch._C._profiler._RecordFunctionFast))
        except (ImportError, AttributeError):
            _PROFILER.append(None)
    ranges = _PROFILER[0]
    if ranges is None or not ranges[0]():
        return None
    return ranges[1](name)


def _refresh() -> None:
    global _ACTIVE
    _ACTIVE = bool(OBSERVERS) or _KERNEL_RANGES


def kernel_ranges(on: bool) -> None:
    """Open a `kernel.<name>` profiler range in every kernel region, or
    stop (the global tracer's enable and disable)."""
    global _KERNEL_RANGES
    _KERNEL_RANGES = bool(on)
    _refresh()


def mine() -> list:
    """The armed observers of this thread."""
    tid = threading.get_ident()
    return [o for o in OBSERVERS if o.thread == tid]


def arm(observer) -> None:
    observer.thread = threading.get_ident()
    OBSERVERS.append(observer)
    _refresh()


def disarm(observer) -> None:
    if observer in OBSERVERS:
        OBSERVERS.remove(observer)
    _refresh()


def in_region() -> bool:
    """Whether this thread is inside a kernel or set-up region: the
    recorder leaves its ops out."""
    return getattr(_LOCAL, "hidden", 0) > 0


def guard_exempt() -> bool:
    """Whether this thread is inside a CPU kernel region or a set-up
    region: the guard leaves its ops alone."""
    return getattr(_LOCAL, "exempt", 0) > 0


def current_stage() -> Optional[str]:
    return _STAGE["name"]


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One kernel launch as the recorder sees it: the wrapper's name,
    its operand shapes, and the bytes moved and operations done that
    its bound counts."""
    name: str
    shapes: Tuple[Tuple[int, ...], ...]
    bytes: int
    flops: int


@contextlib.contextmanager
def _hidden(exempt: bool):
    _LOCAL.hidden = getattr(_LOCAL, "hidden", 0) + 1
    _LOCAL.exempt = getattr(_LOCAL, "exempt", 0) + exempt
    try:
        yield
    finally:
        _LOCAL.hidden -= 1
        _LOCAL.exempt -= exempt


@contextlib.contextmanager
def _region(entry: KernelEntry, exempt: bool, prof_range):
    for o in mine():
        if hasattr(o, "on_kernel"):
            o.on_kernel(entry)
    with prof_range, _hidden(exempt):
        yield


def kernel_region(name: str, device, shapes, nbytes: int, flops: int):
    """The context a kernel wrapper launches in on the card, or runs its
    plain version in on the CPU (`device`: the operands' device)."""
    if not _ACTIVE:
        return _NULL
    prof_range = profiler_range("kernel." + name) if _KERNEL_RANGES else None
    if prof_range is None:
        prof_range = _NULL
    if not OBSERVERS:
        return prof_range
    return _region(KernelEntry(
        name, tuple(tuple(int(d) for d in s) for s in shapes), int(nbytes),
        int(flops)), getattr(device, "type", device) == "cpu", prof_range)


def setup_region():
    """One-time work a round may trigger (the sketch's tables copied to
    a device, its sign bits packed): hidden from the recorders and the
    guard, with no entry, as the JAX tiers see such values as constants
    of the traced program."""
    if not OBSERVERS:
        return _NULL
    return _hidden(True)


@contextlib.contextmanager
def _program(counters: list):
    from commefficient_tpu_torch.analysis.recorder import RoundRecorder
    with RoundRecorder() as rec:
        yield
    digest = rec.digest()
    for c in counters:
        c.on_program(digest)


def program():
    """One train round: its op sequence is recorded and its digest
    counted by the armed program counters of this thread."""
    if not OBSERVERS:
        return _NULL
    counters = [o for o in mine() if hasattr(o, "on_program")]
    return _program(counters) if counters else _NULL


@contextlib.contextmanager
def _stage(name: str):
    prev = _STAGE["name"]
    _STAGE["name"] = name
    try:
        yield
    finally:
        _STAGE["name"] = prev


def stage(name: str):
    """Label the ops dispatched inside with a round stage."""
    if not OBSERVERS:
        return _NULL
    return _stage(name)


_EXPLICIT = threading.local()


@contextlib.contextmanager
def explicit_transfer(reason: str):
    """A deliberate host boundary: syncs inside pass the guard and are
    counted under `reason`."""
    stack = getattr(_EXPLICIT, "stack", None)
    if stack is None:
        stack = _EXPLICIT.stack = []
    stack.append(reason)
    try:
        yield
    finally:
        stack.pop()


def explicit_reason() -> Optional[str]:
    """The innermost open explicit_transfer's reason, or None."""
    stack = getattr(_EXPLICIT, "stack", None)
    return stack[-1] if stack else None
