"""Run journal: the port of commefficient_tpu/telemetry/journal.py.

An append-only JSONL event log. Every record is one JSON object a line
with `v` (schema version), `event` (record kind), `ts` (wall-clock
epoch seconds), its monotonic twin `mono` (durations come from `mono`;
its base is shared only within one process, so a reader resets at each
`run_start`) and the kind's payload. The schema is the JAX package's,
and so is the reader half here (`validate_journal`, `summarize`): each
package's reader reads the other's journals with the same verdicts.
`python -m commefficient_tpu_torch.telemetry.journal_summary
<journal.jsonl>` validates and summarizes one, with the output and exit
codes of the JAX package's scripts/journal_summary.py.

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

from commefficient_tpu_torch.analysis.domains import CONTROL_FIELDS
from commefficient_tpu_torch.telemetry.trace import (
    TRACE, device_busy_wall, stage_stats,
)
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


def validate_journal(path: str,
                     counters: Optional[dict] = None
                     ) -> Tuple[List[dict], List[str]]:
    """The journal's invariants as a checkable function, the JAX
    package's rules (so each package's reader reads the other's
    journals the same way):

      * every line parses as a JSON object with v/event/ts, `v` equal
        to SCHEMA_VERSION, `ts` numeric, `mono` (when present) a
        non-negative number;
      * `round` events carry an integer `round`, never repeated and
        strictly increasing within a run SEGMENT; `metrics` (when
        present) is {str: number or a non-finite sentinel}; `down_bytes`
        / `up_bytes` (when present) are non-negative, and a segment's
        `run_end` down_bytes_total / up_bytes_total cover its per-round
        sums;
      * `schedule` carries an integer `round` and a `sampler` name, with
        non-negative deadline_s / est_round_s / expected_round_s;
        `state_tier` non-negative integer hits / misses / spills /
        restores and non-negative byte and row counts; `trace` a list of
        spans with string name / thread and non-negative t0 / dur, and a
        non-negative integer `dropped`;
      * `screened`, `aggregator`, `screen_adapt`, `privacy` (epsilon
        never decreasing within a segment), `compressor`,
        `numeric_trip` and `state_quarantine` carry their fields with
        their types and signs; `control` carries an integer `round`, a
        `controller` registered in analysis/domains.CONTROL_FIELDS,
        numeric signal / old / new and a bool `clamped`;
      * the analysis tiers' digests: `audit_digest` and
        `mesh_audit_digest` a non-empty `digest` and per-program
        non-negative costs; `sync_audit_digest` and `num_audit_digest`
        a 64-hex `digest`, non-negative integer rule counts and
        `findings`, and for graftnum a non-negative integer `ulp` bound
        a program.

    A `run_start` opens a new segment (a resumed run replays rounds
    journaled after its last checkpoint), and so does a `numeric_trip`
    (the rollback replays rounds) for the round and epsilon tracking;
    byte sums run on across a trip, as the accountant does. Corrupt
    INTERIOR lines are skipped and counted (read_journal), not
    violations: pass `counters` to receive the count for summarize().

    Returns (records, problems); no problems means a valid journal."""
    records, problems = read_journal(path, counters=counters)
    seen_rounds = set()
    last_round = None
    seg_down = seg_up = 0.0
    last_epsilon = None

    def _comm_field(rec, n, field):
        """Validate one byte-total field; returns its value or None."""
        v = rec.get(field)
        if v is None:
            return None
        if not isinstance(v, (int, float)) or v < 0:
            problems.append(
                f"record {n}: `{field}` must be a non-negative "
                f"number (got {v!r})")
            return None
        return float(v)

    for n, rec in enumerate(records, 1):
        if rec.get("event") == "run_start":
            seen_rounds = set()
            last_round = None
            seg_down = seg_up = 0.0
            last_epsilon = None
        # a rollback replays rounds after the trip: round and epsilon
        # tracking restart, byte sums run on (the accountant does)
        if rec.get("event") == "numeric_trip":
            seen_rounds = set()
            last_round = None
            last_epsilon = None
        for field in REQUIRED_FIELDS:
            if field not in rec:
                problems.append(f"record {n}: missing `{field}`")
        v = rec.get("v")
        if v is not None and v != SCHEMA_VERSION:
            problems.append(
                f"record {n}: schema version {v!r} != {SCHEMA_VERSION}")
        if not isinstance(rec.get("ts", 0.0), (int, float)):
            problems.append(f"record {n}: non-numeric `ts`")
        mono = rec.get("mono")
        if mono is not None and not (isinstance(mono, (int, float))
                                     and mono >= 0):
            problems.append(
                f"record {n}: `mono` must be a non-negative number "
                f"(got {mono!r})")
        if rec.get("event") == "trace":
            spans = rec.get("spans")
            if not isinstance(spans, list):
                problems.append(
                    f"record {n}: trace event `spans` is not a list")
            else:
                for j, sp in enumerate(spans):
                    if not isinstance(sp, dict):
                        problems.append(
                            f"record {n}: trace span {j} is not an "
                            "object")
                        continue
                    for field in ("name", "thread"):
                        if not isinstance(sp.get(field), str):
                            problems.append(
                                f"record {n}: trace span {j} "
                                f"`{field}` must be a string (got "
                                f"{sp.get(field)!r})")
                    for field in ("t0", "dur"):
                        v2 = sp.get(field)
                        if not (isinstance(v2, (int, float))
                                and v2 >= 0):
                            problems.append(
                                f"record {n}: trace span {j} "
                                f"`{field}` must be a non-negative "
                                f"number (got {v2!r})")
            d2 = rec.get("dropped")
            if d2 is not None and not (isinstance(d2, int)
                                       and d2 >= 0):
                problems.append(
                    f"record {n}: trace `dropped` must be a "
                    f"non-negative integer (got {d2!r})")
        if rec.get("event") == "schedule":
            if not isinstance(rec.get("round"), int):
                problems.append(
                    f"record {n}: schedule event without an integer "
                    f"`round` (got {rec.get('round')!r})")
            if not isinstance(rec.get("sampler"), str):
                problems.append(
                    f"record {n}: schedule event without a `sampler` "
                    "name")
            for field in ("deadline_s", "est_round_s",
                          "expected_round_s"):
                _comm_field(rec, n, field)
        if rec.get("event") == "state_tier":
            for field in ("hits", "misses", "spills", "restores"):
                v2 = rec.get(field)
                if not (isinstance(v2, int) and v2 >= 0):
                    problems.append(
                        f"record {n}: state_tier `{field}` must be a "
                        f"non-negative integer (got {v2!r})")
            for field in ("spill_bytes", "restore_bytes",
                          "resident", "working_set"):
                _comm_field(rec, n, field)
        if rec.get("event") == "screened":
            if not isinstance(rec.get("round"), int):
                problems.append(
                    f"record {n}: screened event without an integer "
                    f"`round` (got {rec.get('round')!r})")
            ns = rec.get("n_screened")
            if not (isinstance(ns, int) and ns >= 0):
                problems.append(
                    f"record {n}: screened `n_screened` must be a "
                    f"non-negative integer (got {ns!r})")
            k2 = rec.get("kind")
            if not (isinstance(k2, str) and k2):
                problems.append(
                    f"record {n}: screened event without a non-empty "
                    f"string `kind` (got {k2!r})")
        if rec.get("event") == "aggregator":
            if not isinstance(rec.get("round"), int):
                problems.append(
                    f"record {n}: aggregator event without an integer "
                    f"`round` (got {rec.get('round')!r})")
            a2 = rec.get("aggregator")
            if not (isinstance(a2, str) and a2):
                problems.append(
                    f"record {n}: aggregator event without a "
                    f"non-empty string `aggregator` (got {a2!r})")
            for field in ("n_trimmed", "residual_l2"):
                v2 = rec.get(field)
                if not isinstance(v2, (int, float)):
                    problems.append(
                        f"record {n}: aggregator `{field}` must be "
                        f"numeric (got {v2!r})")
            for field in ("n_clipped", "n_contrib"):
                v2 = rec.get(field)
                if not (isinstance(v2, int) and v2 >= 0):
                    problems.append(
                        f"record {n}: aggregator `{field}` must be a "
                        f"non-negative integer (got {v2!r})")
        if rec.get("event") == "screen_adapt":
            if not isinstance(rec.get("round"), int):
                problems.append(
                    f"record {n}: screen_adapt event without an "
                    f"integer `round` (got {rec.get('round')!r})")
            for field in ("rate", "target"):
                v2 = rec.get(field)
                if not isinstance(v2, (int, float)):
                    problems.append(
                        f"record {n}: screen_adapt `{field}` must be "
                        f"numeric (got {v2!r})")
            for field in ("old_mult", "new_mult"):
                v2 = rec.get(field)
                if not (isinstance(v2, (int, float)) and v2 > 0):
                    problems.append(
                        f"record {n}: screen_adapt `{field}` must be "
                        f"a positive number (got {v2!r})")
        if rec.get("event") == "control":
            if not isinstance(rec.get("round"), int):
                problems.append(
                    f"record {n}: control event without an integer "
                    f"`round` (got {rec.get('round')!r})")
            c2 = rec.get("controller")
            if not (isinstance(c2, str) and c2 in CONTROL_FIELDS):
                problems.append(
                    f"record {n}: control `controller` must be a "
                    f"name registered in analysis.domains."
                    f"CONTROL_FIELDS (got {c2!r})")
            for field in ("signal", "old", "new"):
                v2 = rec.get(field)
                if not isinstance(v2, (int, float)):
                    problems.append(
                        f"record {n}: control `{field}` must be "
                        f"numeric (got {v2!r})")
            if not isinstance(rec.get("clamped"), bool):
                problems.append(
                    f"record {n}: control `clamped` must be a bool "
                    f"(got {rec.get('clamped')!r})")
        if rec.get("event") == "privacy":
            if not isinstance(rec.get("round"), int):
                problems.append(
                    f"record {n}: privacy event without an integer "
                    f"`round` (got {rec.get('round')!r})")
            eps = rec.get("epsilon")
            if not (isinstance(eps, (int, float)) and eps >= 0):
                problems.append(
                    f"record {n}: privacy `epsilon` must be a "
                    f"non-negative number (got {eps!r})")
            else:
                if last_epsilon is not None and eps < last_epsilon:
                    problems.append(
                        f"record {n}: privacy `epsilon` decreased "
                        f"({last_epsilon!r} -> {eps!r}) — the RDP "
                        f"budget only accumulates within a segment")
                last_epsilon = float(eps)
            for field in ("sigma", "clip"):
                v2 = rec.get(field)
                if not (isinstance(v2, (int, float)) and v2 > 0):
                    problems.append(
                        f"record {n}: privacy `{field}` must be a "
                        f"positive number (got {v2!r})")
            d3 = rec.get("delta")
            if not (isinstance(d3, (int, float)) and 0 < d3 < 1):
                problems.append(
                    f"record {n}: privacy `delta` must be in (0, 1) "
                    f"(got {d3!r})")
        if rec.get("event") == "compressor":
            if not isinstance(rec.get("round"), int):
                problems.append(
                    f"record {n}: compressor event without an integer "
                    f"`round` (got {rec.get('round')!r})")
            m2 = rec.get("mode")
            if not (isinstance(m2, str) and m2):
                problems.append(
                    f"record {n}: compressor event without a "
                    f"non-empty string `mode` (got {m2!r})")
            for field in ("wire_bytes", "up_bytes"):
                v2 = rec.get(field)
                if not (isinstance(v2, (int, float)) and v2 >= 0):
                    problems.append(
                        f"record {n}: compressor `{field}` must be a "
                        f"non-negative number (got {v2!r})")
        if rec.get("event") == "numeric_trip":
            if not isinstance(rec.get("round"), int):
                problems.append(
                    f"record {n}: numeric_trip event without an "
                    f"integer `round` (got {rec.get('round')!r})")
            m2 = rec.get("metrics")
            if not (isinstance(m2, list)
                    and all(isinstance(x, str) for x in m2)):
                problems.append(
                    f"record {n}: numeric_trip `metrics` must be a "
                    f"list of metric-name strings (got {m2!r})")
        if rec.get("event") == "state_quarantine":
            c2 = rec.get("client")
            if not (isinstance(c2, int) and c2 >= 0):
                problems.append(
                    f"record {n}: state_quarantine `client` must be "
                    f"a non-negative integer (got {c2!r})")
            f2 = rec.get("field")
            if not (isinstance(f2, str) and f2):
                problems.append(
                    f"record {n}: state_quarantine event without a "
                    f"non-empty string `field` (got {f2!r})")
        # graftaudit / graftmesh: a digest and per-program costs
        digest_fields = {
            "audit_digest": ("flops", "hbm_bytes"),
            "mesh_audit_digest": ("ici_bytes", "dcn_bytes",
                                  "dcn_collectives"),
        }
        ev = rec.get("event")
        if ev in digest_fields:
            d = rec.get("digest")
            if not (isinstance(d, str) and d):
                problems.append(
                    f"record {n}: {ev} without a non-empty "
                    f"string `digest` (got {d!r})")
            progs = rec.get("programs")
            if not isinstance(progs, dict):
                problems.append(
                    f"record {n}: {ev} `programs` is not an "
                    "object")
            else:
                for prog, cost in sorted(progs.items()):
                    if not isinstance(cost, dict):
                        problems.append(
                            f"record {n}: {ev} program "
                            f"{prog!r} cost is not an object")
                        continue
                    for field in digest_fields[ev]:
                        v2 = cost.get(field)
                        if not (isinstance(v2, (int, float))
                                and v2 >= 0):
                            problems.append(
                                f"record {n}: {ev} program "
                                f"{prog!r} `{field}` must be a "
                                f"non-negative number (got {v2!r})")
        # graftsync / graftnum digests are pinned to 64 lowercase hex
        if rec.get("event") in ("sync_audit_digest",
                                "num_audit_digest"):
            ev2 = rec.get("event")
            d = rec.get("digest")
            if not (isinstance(d, str) and len(d) == 64
                    and all(c in "0123456789abcdef" for c in d)):
                problems.append(
                    f"record {n}: {ev2} `digest` must be "
                    f"a 64-char lowercase hex string (got {d!r})")
            rls = rec.get("rules")
            if not isinstance(rls, dict):
                problems.append(
                    f"record {n}: {ev2} `rules` is not "
                    "an object")
            else:
                for rule, cnt in sorted(rls.items()):
                    if not (isinstance(cnt, int) and cnt >= 0):
                        problems.append(
                            f"record {n}: {ev2} rule "
                            f"{rule!r} count must be a non-negative "
                            f"integer (got {cnt!r})")
            fnd = rec.get("findings")
            if fnd is not None and not (isinstance(fnd, int)
                                        and fnd >= 0):
                problems.append(
                    f"record {n}: {ev2} `findings` must "
                    f"be a non-negative integer (got {fnd!r})")
        if rec.get("event") == "num_audit_digest":
            ulp = rec.get("ulp")
            if not isinstance(ulp, dict):
                problems.append(
                    f"record {n}: num_audit_digest `ulp` is not an "
                    "object")
            else:
                for prog, bound in sorted(ulp.items()):
                    if not (isinstance(bound, int) and bound >= 0):
                        problems.append(
                            f"record {n}: num_audit_digest program "
                            f"{prog!r} ulp bound must be a "
                            f"non-negative integer (got {bound!r})")
        if rec.get("event") == "run_end":
            total_down = _comm_field(rec, n, "down_bytes_total")
            total_up = _comm_field(rec, n, "up_bytes_total")
            if total_down is not None and total_down < seg_down - 0.5:
                problems.append(
                    f"record {n}: down_bytes_total {total_down} < "
                    f"sum of per-round down_bytes {seg_down}")
            if total_up is not None and total_up < seg_up - 0.5:
                problems.append(
                    f"record {n}: up_bytes_total {total_up} < "
                    f"sum of per-round up_bytes {seg_up}")
        if rec.get("event") == "round":
            d = _comm_field(rec, n, "down_bytes")
            u = _comm_field(rec, n, "up_bytes")
            seg_down += d or 0.0
            seg_up += u or 0.0
            r = rec.get("round")
            if not isinstance(r, int):
                problems.append(f"record {n}: round event without an "
                                f"integer `round` (got {r!r})")
                continue
            if r in seen_rounds:
                problems.append(f"record {n}: duplicate round {r}")
            elif last_round is not None and r <= last_round:
                problems.append(
                    f"record {n}: round {r} out of order "
                    f"(after round {last_round})")
            seen_rounds.add(r)
            last_round = r if last_round is None else max(last_round, r)
            m = rec.get("metrics")
            if m is not None:
                if not isinstance(m, dict):
                    problems.append(
                        f"record {n}: `metrics` is not an object")
                else:
                    # the non-finite sentinels (_finite) are legal telemetry
                    ok_strings = set(NONFINITE.values())
                    bad = [k for k, val in m.items()
                           if not (isinstance(val, (int, float))
                                   or val in ok_strings)]
                    if bad:
                        problems.append(
                            f"record {n}: non-numeric metrics {bad}")
    return records, problems


# inter-round cadence histogram buckets (seconds)
_CADENCE_EDGES = (
    (0.001, "<1ms"), (0.003, "1-3ms"), (0.01, "3-10ms"),
    (0.03, "10-30ms"), (0.1, "30-100ms"), (0.3, "0.1-0.3s"),
    (1.0, "0.3-1s"), (3.0, "1-3s"), (10.0, "3-10s"),
)


def _cadence_bucket(dt: float) -> str:
    for edge, label in _CADENCE_EDGES:
        if dt < edge:
            return label
    return ">=10s"


def summarize(records: List[dict], corrupt_lines: int = 0) -> dict:
    """A small digest of a journal: event-kind counts, round coverage,
    journaled span and checkpoint seconds, byte totals, and the blocks
    of the kinds present (robustness counters, the privacy budget, the
    compressor modes' bytes, the controllers' moves, the state tier's
    hit rate, the inter-round cadence on the monotonic clock reset at
    every run_start, the trace spans' per-stage p50/p95, writer queue
    depths and overlap efficiency per segment, and the analysis tiers'
    digests). `corrupt_lines`: the skipped interior lines read_journal
    counted."""
    kinds: dict = {}
    rounds = []
    span_s = ckpt_s = 0.0
    down_b = up_b = 0.0
    deadlines = 0
    tier_hits = tier_misses = tier_spills = 0
    tier_spill_b = 0.0
    screened_total = 0
    trimmed_total = 0.0
    clipped_total = 0
    epsilon_spent = None
    privacy_sigma = privacy_delta = None
    wire_by_mode: dict = {}
    control_by_ctl: dict = {}
    # trace spans split at run_start: monotonic bases differ across
    # processes, so the busy/wall extents never mix segments
    trace_segments: List[List[dict]] = [[]]
    trace_dropped = 0
    cadence: List[float] = []
    prev_mono = None
    # the analysis tiers' digests: the last record of each wins
    tier_digests: dict = {}
    num_findings = None
    for rec in records:
        kind = rec.get("event", "?")
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind in ("audit_digest", "mesh_audit_digest",
                    "sync_audit_digest", "num_audit_digest"):
            d = rec.get("digest")
            if isinstance(d, str) and d:
                tier_digests[kind] = d
            if kind == "num_audit_digest":
                f2 = rec.get("findings")
                if isinstance(f2, int):
                    num_findings = f2
        if kind == "run_start":
            prev_mono = None
            if trace_segments[-1]:
                trace_segments.append([])
        if kind == "trace":
            spans = rec.get("spans")
            if isinstance(spans, list):
                trace_segments[-1].extend(
                    sp for sp in spans if isinstance(sp, dict))
            d = rec.get("dropped")
            if isinstance(d, int) and d > 0:
                trace_dropped += d
        if kind == "screened":
            screened_total += int(rec.get("n_screened", 0) or 0)
        if kind == "aggregator":
            trimmed_total += float(rec.get("n_trimmed", 0) or 0)
            clipped_total += int(rec.get("n_clipped", 0) or 0)
        if kind == "privacy":
            eps = rec.get("epsilon")
            if isinstance(eps, (int, float)):
                epsilon_spent = float(eps)
            if isinstance(rec.get("sigma"), (int, float)):
                privacy_sigma = float(rec["sigma"])
            if isinstance(rec.get("delta"), (int, float)):
                privacy_delta = float(rec["delta"])
        if kind == "compressor":
            m2 = rec.get("mode")
            ub = rec.get("up_bytes")
            if isinstance(m2, str) and isinstance(ub, (int, float)):
                acc = wire_by_mode.setdefault(
                    m2, {"rounds": 0, "up_bytes": 0.0,
                         "wire_bytes": 0.0})
                acc["rounds"] += 1
                acc["up_bytes"] += float(ub)
                if isinstance(rec.get("wire_bytes"), (int, float)):
                    acc["wire_bytes"] = float(rec["wire_bytes"])
        if kind == "control":
            c2 = rec.get("controller")
            if isinstance(c2, str) and c2:
                acc = control_by_ctl.setdefault(
                    c2, {"adjustments": 0, "clamped": 0,
                         "final": None})
                acc["adjustments"] += 1
                if rec.get("clamped") is True:
                    acc["clamped"] += 1
                if isinstance(rec.get("new"), (int, float)):
                    acc["final"] = float(rec["new"])
        if kind == "state_tier":
            tier_hits += int(rec.get("hits", 0) or 0)
            tier_misses += int(rec.get("misses", 0) or 0)
            tier_spills += int(rec.get("spills", 0) or 0)
            tier_spill_b += float(rec.get("spill_bytes", 0) or 0)
        if kind == "round" and isinstance(rec.get("round"), int):
            rounds.append(rec["round"])
            mono = rec.get("mono")
            if isinstance(mono, (int, float)):
                if prev_mono is not None and mono > prev_mono:
                    cadence.append(float(mono) - prev_mono)
                prev_mono = float(mono)
            if isinstance(rec.get("down_bytes"), (int, float)):
                down_b += float(rec["down_bytes"])
            if isinstance(rec.get("up_bytes"), (int, float)):
                up_b += float(rec["up_bytes"])
        elif kind == "span":
            span_s += float(rec.get("dispatch_s", 0.0))
            span_s += float(rec.get("block_s", 0.0))
        elif kind == "checkpoint":
            ckpt_s += float(rec.get("seconds", 0.0))
        elif kind == "schedule" and rec.get("deadline_s") is not None:
            deadlines += 1
    out = {
        "records": len(records),
        "events": dict(sorted(kinds.items())),
        "rounds": len(rounds),
        "first_round": min(rounds) if rounds else None,
        "last_round": max(rounds) if rounds else None,
        "span_seconds": round(span_s, 3),
        "checkpoint_seconds": round(ckpt_s, 3),
        "down_mib": round(down_b / (1024 ** 2), 3),
        "up_mib": round(up_b / (1024 ** 2), 3),
        "deadline_rounds": deadlines,
    }
    if (kinds.get("screened") or kinds.get("numeric_trip")
            or kinds.get("state_quarantine")):
        out["screened_total"] = screened_total
        out["numeric_trips"] = kinds.get("numeric_trip", 0)
        out["state_quarantines"] = kinds.get("state_quarantine", 0)
    if kinds.get("aggregator") or kinds.get("screen_adapt"):
        out["trimmed_total"] = round(trimmed_total, 3)
        out["clipped_total"] = clipped_total
        out["screen_adaptations"] = kinds.get("screen_adapt", 0)
    if epsilon_spent is not None:
        out["epsilon_spent"] = round(epsilon_spent, 6)
        if privacy_sigma is not None:
            out["privacy_sigma"] = privacy_sigma
        if privacy_delta is not None:
            out["privacy_delta"] = privacy_delta
    if wire_by_mode:
        out["compressor_modes"] = {
            m: {"rounds": acc["rounds"],
                "wire_bytes": round(acc["wire_bytes"], 3),
                "up_mib": round(acc["up_bytes"] / (1024 ** 2), 3)}
            for m, acc in sorted(wire_by_mode.items())}
    if control_by_ctl:
        out["controllers"] = {
            c: {"adjustments": acc["adjustments"],
                "clamped": acc["clamped"],
                "final": (None if acc["final"] is None
                          else round(acc["final"], 6))}
            for c, acc in sorted(control_by_ctl.items())}
    if tier_hits or tier_misses:
        out["state_hit_rate"] = round(
            tier_hits / max(tier_hits + tier_misses, 1), 4)
        out["state_spills"] = tier_spills
        out["state_spill_mib"] = round(tier_spill_b / (1024 ** 2), 3)
    if cadence:
        hist: dict = {}
        for dt in cadence:
            label = _cadence_bucket(dt)
            hist[label] = hist.get(label, 0) + 1
        srt = sorted(cadence)
        out["cadence"] = {
            "rounds": len(cadence),
            "p50_s": round(srt[min(len(srt) // 2, len(srt) - 1)], 6),
            "p95_s": round(
                srt[min(int(0.95 * len(srt)), len(srt) - 1)], 6),
            "hist": hist,
        }
    trace_spans = [sp for seg in trace_segments for sp in seg]
    if trace_spans:
        out["trace_spans"] = len(trace_spans)
        out["trace_stages"] = stage_stats(trace_spans)
        busy = wall = 0.0
        for seg in trace_segments:
            bw = device_busy_wall(seg)
            if bw is not None:
                busy += bw[0]
                wall += bw[1]
        if wall > 0:
            out["overlap_efficiency"] = round(min(busy / wall, 1.0), 4)
        qmax: dict = {}
        for sp in trace_spans:
            q = sp.get("q")
            name = sp.get("name", "")
            if isinstance(q, int) and isinstance(name, str) \
                    and name.endswith("_enqueue"):
                writer = name[:-len("_enqueue")]
                qmax[writer] = max(qmax.get(writer, 0), q)
        if qmax:
            out["writer_queue_max"] = dict(sorted(qmax.items()))
        if trace_dropped:
            out["trace_dropped"] = trace_dropped
    if tier_digests:
        out["analysis_digests"] = dict(sorted(tier_digests.items()))
        if num_findings is not None:
            out["num_audit_findings"] = num_findings
    if corrupt_lines:
        out["corrupt_lines"] = int(corrupt_lines)
    return out
