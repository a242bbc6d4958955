"""Stage tracing: the port's copy of commefficient_tpu/telemetry/trace.py.

Monotonic-clock spans around the host stages of a round (train_round,
data_fetch, plan, stage, dispatch, gather, round_dispatch,
client_forward, client_backward, server_update, decode, scatter,
collect, account, checkpoint, journal_write), buffered in per-thread
rings and flushed by the telemetry session as batched `trace` journal
events.

The global `TRACE` is always there and OFF by default: a disabled
`TRACE.span(...)` costs one attribute check and returns a shared no-op
context manager. `--trace` enables it for one run (the session owns
it and disables it at close). Spans bracket host code only, so
tracing changes no tensor a round computes.

A span record is {"name", "t0" (monotonic s), "dur", "thread", ...tags};
nested spans and instants inherit their enclosing span's `round` and
`span` tags on the same thread. `Tracer.add` adds to a counter of the
innermost open span (`data_fetch`'s `bytes_read`).

While a tracer is on and torch's profiler records in this process, each
of its spans is also a range of the span's name on the profiler's clock
(hooks.profiler_range), so a profile names the host time a span holds:
the benchmark's device trace (portbench/devtrace.py), `--profile` and
`--profile_spans`. The global `TRACE` also turns on the kernel regions'
`kernel.<name>` ranges (hooks.kernel_ranges). Torch is imported when
the first span opens while on: this module imports without it.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from commefficient_tpu_torch import hooks

__all__ = ["TRACE", "Tracer", "device_busy_wall", "overlap_efficiency",
           "stage_stats"]

# tags inherited by nested spans and instants from the innermost open
# span on the same thread
_INHERITED_TAGS = ("round", "span")


class _NullSpan:
    """Shared no-op context manager: the disabled path allocates
    nothing per call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One open span; commits its record on exit."""

    __slots__ = ("_tracer", "rec", "_stack", "_range")

    def __init__(self, tracer: "Tracer", rec: dict, stack: list):
        self._tracer = tracer
        self.rec = rec
        self._stack = stack
        self._range = None

    def __enter__(self):
        self._range = hooks.profiler_range(self.rec["name"])
        if self._range is not None:
            self._range.__enter__()
        self.rec["t0"] = self._tracer._clock()
        self._stack.append(self.rec)
        return self

    def __exit__(self, *exc):
        t1 = self._tracer._clock()
        stack = self._stack
        if stack and stack[-1] is self.rec:
            stack.pop()
        rec = self.rec
        rec["dur"] = round(t1 - rec["t0"], 6)
        rec["t0"] = round(rec["t0"], 6)
        self._tracer._commit(rec)
        if self._range is not None:
            self._range.__exit__(None, None, None)
        return False


class Tracer:
    """Per-thread ring buffers of monotonic-clock stage spans. One
    small lock guards ring append and drain; a full ring drops and
    counts."""

    def __init__(self, enabled: bool = False, controller: int = 0,
                 ring_size: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 on_toggle: Optional[Callable[[bool], None]] = None):
        self.enabled = bool(enabled)
        self.controller = int(controller)
        self.ring_size = int(ring_size)
        self._clock = clock
        self._lock = threading.Lock()
        self._rings: Dict[int, List[dict]] = {}
        self._dropped = 0
        # per-thread stack of OPEN span records (tag inheritance)
        self._open = threading.local()
        # called with the new state at enable and disable
        self._on_toggle = on_toggle

    def _thread_stack(self) -> list:
        stack = getattr(self._open, "stack", None)
        if stack is None:
            stack = self._open.stack = []
        return stack

    def _make_rec(self, name: str, tags: dict) -> Tuple[dict, list]:
        rec = {"name": str(name),
               "thread": threading.current_thread().name}
        stack = self._thread_stack()
        if stack:
            parent = stack[-1]
            for key in _INHERITED_TAGS:
                if key in parent and key not in tags:
                    rec[key] = parent[key]
        for k, v in tags.items():
            if v is not None:
                rec[k] = v
        return rec, stack

    def current_tags(self) -> dict:
        """The innermost open span's correlation tags on this thread,
        or {}."""
        if not self.enabled:
            return {}
        stack = self._thread_stack()
        if not stack:
            return {}
        parent = stack[-1]
        return {k: parent[k] for k in _INHERITED_TAGS if k in parent}

    def span(self, name: str, **tags):
        """Context manager bracketing one stage; the disabled path
        returns a shared no-op."""
        if not self.enabled:
            return _NULL_SPAN
        rec, stack = self._make_rec(name, tags)
        return _Span(self, rec, stack)

    def add(self, key: str, n) -> None:
        """Add `n` to counter `key` of the innermost open span on this
        thread; a no-op when off or outside every span."""
        if not self.enabled:
            return
        stack = self._thread_stack()
        if stack:
            rec = stack[-1]
            rec[key] = rec.get(key, 0) + n

    def instant(self, name: str, **tags) -> None:
        """Zero-duration marker."""
        if not self.enabled:
            return
        rec, _ = self._make_rec(name, tags)
        rec["t0"] = round(self._clock(), 6)
        rec["dur"] = 0.0
        self._commit(rec)

    def record(self, name: str, t0: float, t1: float, **tags) -> None:
        """Commit a span with explicit monotonic endpoints."""
        if not self.enabled:
            return
        rec, _ = self._make_rec(name, tags)
        rec["t0"] = round(float(t0), 6)
        rec["dur"] = round(max(float(t1) - float(t0), 0.0), 6)
        self._commit(rec)

    def _commit(self, rec: dict) -> None:
        if not self.enabled:
            # a span that straddled disable (session close) drops
            return
        ident = threading.get_ident()
        with self._lock:
            ring = self._rings.get(ident)
            if ring is None:
                ring = self._rings[ident] = []
            if len(ring) >= self.ring_size:
                self._dropped += 1
                return
            ring.append(rec)

    def drain(self) -> Tuple[List[dict], int]:
        """Swap out every thread's ring: (spans sorted by t0, drops
        since the last drain)."""
        with self._lock:
            spans: List[dict] = []
            for ident in list(self._rings):
                ring = self._rings[ident]
                if ring:
                    spans.extend(ring)
                    self._rings[ident] = []
            dropped, self._dropped = self._dropped, 0
        spans.sort(key=lambda r: r.get("t0", 0.0))
        return spans, dropped

    def enable(self, controller: Optional[int] = None) -> None:
        if controller is not None:
            self.controller = int(controller)
        self.enabled = True
        if self._on_toggle is not None:
            self._on_toggle(True)

    def disable(self) -> None:
        """Turn tracing off and discard anything buffered."""
        self.enabled = False
        if self._on_toggle is not None:
            self._on_toggle(False)
        with self._lock:
            self._rings.clear()
            self._dropped = 0


# The process-global tracer every instrumentation site records into; it
# also turns the kernel regions' profiler ranges on and off.
TRACE = Tracer(enabled=False, on_toggle=hooks.kernel_ranges)


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted list."""
    if not sorted_vals:
        return 0.0
    idx = min(int(q / 100.0 * len(sorted_vals)), len(sorted_vals) - 1)
    return sorted_vals[idx]


def stage_stats(spans: List[dict]) -> dict:
    """Per-stage duration stats over span records: count, p50/p95 and
    total seconds."""
    by_stage: Dict[str, List[float]] = {}
    for rec in spans:
        name = rec.get("name")
        dur = rec.get("dur")
        if not isinstance(name, str) or not isinstance(dur, (int, float)):
            continue
        by_stage.setdefault(name, []).append(float(dur))
    out = {}
    for name in sorted(by_stage):
        durs = sorted(by_stage[name])
        out[name] = {
            "n": len(durs),
            "p50_s": round(_percentile(durs, 50), 6),
            "p95_s": round(_percentile(durs, 95), 6),
            "total_s": round(sum(durs), 6),
        }
    return out


# the training loop's spans around the round's stages: they take in the
# batch's fetch and the round's tail (logging, hooks), which are no part
# of the stages' wall
_OUTSIDE_WALL = ("train_round", "data_fetch")


def device_busy_wall(spans: List[dict]
                     ) -> Optional[Tuple[float, float]]:
    """(device-busy seconds, wall seconds) over ONE trace segment (one
    process lifetime): busy is the union of the `device_execute`
    spans' intervals, wall the extent of the segment's stage spans
    (all but `_OUTSIDE_WALL`). None without device_execute spans or a
    wall extent."""
    dev = sorted((float(r["t0"]), float(r["t0"]) + float(r["dur"]))
                 for r in spans
                 if r.get("name") == "device_execute"
                 and isinstance(r.get("t0"), (int, float))
                 and isinstance(r.get("dur"), (int, float)))
    stages = [r for r in spans if isinstance(r.get("t0"), (int, float))
              and r.get("name") not in _OUTSIDE_WALL]
    times = [float(r["t0"]) for r in stages]
    ends = [float(r["t0"]) + float(r.get("dur", 0.0)) for r in stages]
    if not dev or not times:
        return None
    wall = max(ends) - min(times)
    if wall <= 0:
        return None
    busy = 0.0
    cur_lo, cur_hi = dev[0]
    for lo, hi in dev[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    return busy, wall


def overlap_efficiency(spans: List[dict]) -> Optional[float]:
    """Device-busy time over wall time in one trace segment (1.0: the
    device never waited on the host)."""
    bw = device_busy_wall(spans)
    if bw is None:
        return None
    busy, wall = bw
    return round(min(busy / wall, 1.0), 4)
