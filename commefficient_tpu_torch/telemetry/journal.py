"""Run journal, the writer half: the port of
commefficient_tpu/telemetry/journal.py.

An append-only JSONL event log. Every record is one JSON object a line
with `v` (schema version), `event` (record kind), `ts` (wall-clock
epoch seconds), its monotonic twin `mono` (durations come from `mono`;
its base is shared only within one process, so a reader resets at each
`run_start`) and the kind's payload. The schema is the JAX package's,
so its `scripts/journal_summary.py` (validate_journal, summarize)
reads a port journal unchanged; the reader half stays there (ROADMAP.md
Queue 1 item 10).

Kinds the port writes: run_start / run_end (config snapshot; run_end
carries down_bytes_total / up_bytes_total), round (`round`, `metrics`
named per telemetry.metrics.METRIC_NAMES, `seconds`, `down_bytes`,
`up_bytes`), compressor (the round's mode, wire geometry, upload total
and the frozen coordinate count of --finetune), epoch, checkpoint
(`path`, `seconds`), checkpoint_fallback, numeric_trip, trace (batched
stage spans, telemetry/trace.py), and for a faulted round (federated/
api.py) schedule (`round`, `sampler`, `n_sampled` the clients that
completed it; in the screened family `screen_on` and `n_poisoned`),
screened (`round`, `n_screened`, `kind` finite or norm), aggregator
(`round`, `aggregator`, `n_trimmed`, `n_clipped`, `residual_l2`, -1.0
when non-finite, `n_contrib`) and injected_fault (`fault`, `round`).

Durability: every append goes through
utils/atomic_io.atomic_append_lines (flush + fsync a batch); a
preemption can tear at most the final line, which `read_journal`
reports without losing the committed records before it. Under
--pipeline (`async_writer=True`) the appends ride one bounded-queue
writer thread: the records are serialized on the caller's thread and
written FIFO through the same path, so their content, order, batching
and the torn-tail seal are the synchronous writer's; `flush()` is the
barrier.

The scanned-span path adds `span` (`first_round`, `rounds`,
`dispatch_s`, `block_s`), `privacy` (dp_sketch: `round`, `epsilon`,
`sigma`, `clip`, `delta`), `retry` and `profile_start` /
`profile_stop` (`span`, `dir`).
"""
from __future__ import annotations

import json
import math
import os
import queue
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from commefficient_tpu_torch.telemetry.trace import TRACE
from commefficient_tpu_torch.utils.atomic_io import atomic_append_lines
from commefficient_tpu_torch.utils.watchdog import drain_queue

SCHEMA_VERSION = 1

# fields every record must carry to be schema-valid
REQUIRED_FIELDS = ("v", "event", "ts")


def _jsonable(obj):
    """json.dumps default hook: numpy scalars and arrays -> python."""
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"not JSON-serializable: {type(obj).__name__}")


# strict-JSON sentinels for non-finite floats (see _finite)
NONFINITE = {"nan": "NaN", "inf": "Infinity", "-inf": "-Infinity"}


def _finite(obj):
    """Replace non-finite floats with their string sentinels, recursively:
    json would write bare `NaN` tokens, which strict JSON readers refuse,
    and a diverging run's loss is when the journal matters most."""
    if isinstance(obj, float) and not np.isfinite(obj):
        return NONFINITE[repr(obj)]
    if isinstance(obj, np.floating) and not np.isfinite(obj):
        return NONFINITE[repr(float(obj))]
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


NONFINITE_INVERSE = {"NaN": math.nan, "Infinity": math.inf,
                     "-Infinity": -math.inf}


def _unfinite(obj):
    """Inverse of `_finite` (read_journal applies it): only the three
    exact sentinels convert back; dict keys are never rewritten."""
    if isinstance(obj, str):
        return NONFINITE_INVERSE.get(obj, obj)
    if isinstance(obj, dict):
        return {k: _unfinite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unfinite(v) for v in obj]
    return obj


class RunJournal:
    """Append-only JSONL writer for one run. Construction creates the
    parent directory and writes nothing; the first `event()` creates
    the file. Synchronously, every record is durable when `event`
    returns. With `async_writer` (--pipeline) the serialized lines go
    through a queue of `max_queue` appends to one writer thread:
    `flush()` blocks until everything queued is durable, `close()`
    flushes and stops the thread; a writer-side I/O failure warns once
    and training continues. `drain_timeout` bounds both waits
    (utils/watchdog)."""

    _SENTINEL = object()

    def __init__(self, path: str, run_id: str = "",
                 clock: Callable[[], float] = time.time,
                 mono_clock: Callable[[], float] = time.monotonic,
                 async_writer: bool = False, max_queue: int = 256,
                 drain_timeout: float = 0.0):
        self.path = path
        self.run_id = run_id
        self._clock = clock
        self._mono = mono_clock
        # a torn tail can only predate this writer's first append
        self._tail_checked = False
        self._seq = 0
        self._drain_timeout = float(drain_timeout)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._q: Optional["queue.Queue"] = None
        self._thread = None
        self._warned = False
        if async_writer:
            self._q = queue.Queue(maxsize=max(max_queue, 1))
            self._thread = threading.Thread(
                target=self._drain_loop, args=(self._q,),
                name="journal-writer", daemon=True)
            self._thread.start()

    def _record(self, kind: str, fields: dict) -> dict:
        rec = {"v": SCHEMA_VERSION, "event": str(kind),
               "ts": round(float(self._clock()), 6),
               "mono": round(float(self._mono()), 6)}
        if self.run_id:
            rec["run_id"] = self.run_id
        rec.update(fields)
        return rec

    def _drain_loop(self, q: "queue.Queue") -> None:
        # the queue comes in as an argument: close() detaches self._q
        # before the final join
        while True:
            item = q.get()
            try:
                if item is self._SENTINEL:
                    return
                lines, check_tail, enq_mono, seq, tags = item
                try:
                    if enq_mono is not None:
                        TRACE.record("journal_qwait", enq_mono,
                                     time.monotonic(), seq=seq, **tags)
                        with TRACE.span("journal_write", seq=seq, **tags):
                            atomic_append_lines(self.path, lines,
                                                check_tail)
                    else:
                        atomic_append_lines(self.path, lines, check_tail)
                except (OSError, ValueError) as e:
                    # observability never kills training
                    if not self._warned:
                        print(f"journal writer: append failed ({e}); "
                              f"further failures silent")
                        self._warned = True
            finally:
                q.task_done()

    def _emit(self, lines, trace_tags: Optional[dict]) -> None:
        """Append (or queue) serialized lines, inside a `journal_write`
        span when tracing (trace_tags None: the flush of `trace`
        records itself, never traced)."""
        check_tail = not self._tail_checked
        self._tail_checked = True
        traced = trace_tags is not None and TRACE.enabled
        if self._q is not None:
            if traced:
                seq, self._seq = self._seq, self._seq + 1
                TRACE.instant("journal_enqueue", seq=seq,
                              q=self._q.qsize(), **trace_tags)
                self._q.put((list(lines), check_tail, time.monotonic(),
                             seq, dict(trace_tags)))
            else:
                self._q.put((list(lines), check_tail, None, 0, {}))
            return
        if traced:
            with TRACE.span("journal_write", **trace_tags):
                atomic_append_lines(self.path, lines, check_tail)
        else:
            atomic_append_lines(self.path, lines, check_tail)

    @staticmethod
    def _tags_of(recs) -> Optional[dict]:
        """Correlation tags of one append: the first record's round
        index; None for `trace` records."""
        if any(r.get("event") == "trace" for r in recs):
            return None
        for r in recs:
            for key in ("round", "first_round"):
                v = r.get(key)
                if isinstance(v, int):
                    return {"round": v}
        return {}

    def event(self, kind: str, /, **fields) -> dict:
        """Append one record; returns the dict written. `kind` is
        positional-only, so a payload field may be named `kind`."""
        rec = self._record(kind, fields)
        self._emit((json.dumps(_finite(rec), default=_jsonable),),
                   self._tags_of((rec,)))
        return rec

    def events(self, batch) -> List[dict]:
        """Append many (kind, fields) records with ONE flush + fsync
        (one queued append under the writer thread)."""
        recs = [self._record(kind, fields) for kind, fields in batch]
        self._emit([json.dumps(_finite(r), default=_jsonable)
                    for r in recs], self._tags_of(recs))
        return recs

    def flush(self) -> None:
        """Block until every queued record is durable (a no-op for the
        synchronous writer, whose `event` already fsynced)."""
        if self._q is not None:
            drain_queue(self._q, self._drain_timeout, "journal")

    def close(self) -> None:
        """Flush and stop the writer thread. Idempotent."""
        if self._q is not None:
            q, self._q = self._q, None
            drain_queue(q, self._drain_timeout, "journal")
            q.put(self._SENTINEL)
            self._thread.join()
            self._thread = None


def append_event(path: str, kind: str, /, **fields) -> dict:
    """One-shot append for producers without a long-lived journal."""
    return RunJournal(path).event(kind, **fields)


def read_journal(path: str,
                 counters: Optional[dict] = None
                 ) -> Tuple[List[dict], List[str]]:
    """Parse a journal: (records in order, problems). A torn FINAL line
    is a problem that leaves the records before it standing; corrupt
    interior lines are skipped and counted in `counters`
    ("corrupt_interior", "corrupt_lines")."""
    records: List[dict] = []
    problems: List[str] = []
    skipped: List[int] = []
    with open(path) as f:
        lines = f.read().splitlines()

    def _skip_or_problem(i: int, desc: str) -> None:
        if i == len(lines):
            problems.append(f"line {i}: {desc} (torn tail?)")
        else:
            skipped.append(i)

    for i, line in enumerate(lines, 1):
        if not line.strip():
            _skip_or_problem(i, "blank line")
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            _skip_or_problem(i, "not valid JSON")
            continue
        if not isinstance(rec, dict):
            _skip_or_problem(i, "not a JSON object")
            continue
        records.append(_unfinite(rec))
    if counters is not None:
        counters["corrupt_interior"] = len(skipped)
        counters["corrupt_lines"] = list(skipped)
    return records, problems
