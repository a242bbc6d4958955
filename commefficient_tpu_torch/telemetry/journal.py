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
reports without losing the committed records before it.
"""
from __future__ import annotations

import json
import math
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from commefficient_tpu_torch.config import Q_SCALE
from commefficient_tpu_torch.telemetry.trace import TRACE
from commefficient_tpu_torch.utils.atomic_io import atomic_append_lines

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
    the file. Every record is durable when `event` returns.

    async_writer=True (a writer thread, the JAX package's --pipeline)
    belongs to the pipelined engine and raises NotImplementedError."""

    def __init__(self, path: str, run_id: str = "",
                 clock: Callable[[], float] = time.time,
                 mono_clock: Callable[[], float] = time.monotonic,
                 async_writer: bool = False):
        if async_writer:
            raise NotImplementedError(
                "the journal's writer thread (--pipeline) is not ported "
                f"to commefficient_tpu_torch yet (ROADMAP.md {Q_SCALE})")
        self.path = path
        self.run_id = run_id
        self._clock = clock
        self._mono = mono_clock
        # a torn tail can only predate this writer's first append
        self._tail_checked = False
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def _record(self, kind: str, fields: dict) -> dict:
        rec = {"v": SCHEMA_VERSION, "event": str(kind),
               "ts": round(float(self._clock()), 6),
               "mono": round(float(self._mono()), 6)}
        if self.run_id:
            rec["run_id"] = self.run_id
        rec.update(fields)
        return rec

    def _emit(self, lines, trace_tags: Optional[dict]) -> None:
        """Append serialized lines, inside a `journal_write` span when
        tracing (trace_tags None: the flush of `trace` records itself,
        never traced)."""
        check_tail = not self._tail_checked
        self._tail_checked = True
        if trace_tags is not None and TRACE.enabled:
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
        """Append many (kind, fields) records with ONE flush + fsync."""
        recs = [self._record(kind, fields) for kind, fields in batch]
        self._emit([json.dumps(_finite(r), default=_jsonable)
                    for r in recs], self._tags_of(recs))
        return recs

    def flush(self) -> None:
        """Nothing is buffered: `event` already fsynced."""

    def close(self) -> None:
        """Nothing to release; kept so callers treat the journal like a
        file handle."""


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
