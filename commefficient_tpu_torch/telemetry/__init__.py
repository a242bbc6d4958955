"""The run's observability: the port of the per-round half of
commefficient_tpu/telemetry/__init__.py.

`TelemetrySession` is the host-side conductor FedModel feeds
(`FedModel.attach_telemetry`): each round it buffers the round's
device metric vector (telemetry/metrics.py) and example counts, and
materializes and journals the PREVIOUS round's, with the seconds
between the two dispatches and the accountant's byte totals; it feeds
the model's throughput tracker (telemetry/clients.py), flushes the
stage tracer (telemetry/trace.py) at every round boundary, and trips
on a non-finite update or error norm.

The JAX package's scanned-span path (`on_span`, the `--profile_spans`
capture) belongs to item 9 (ROADMAP.md Queue 1). The port compiles
nothing, so it journals no `compile` events.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from commefficient_tpu_torch.telemetry import metrics as tmetrics
from commefficient_tpu_torch.telemetry.clients import ClientThroughputTracker
from commefficient_tpu_torch.telemetry.journal import RunJournal, append_event
from commefficient_tpu_torch.telemetry.trace import TRACE

__all__ = [
    "ClientThroughputTracker", "NumericTripError", "RunJournal",
    "TRACE", "TelemetrySession", "append_event", "attach_run_telemetry",
    "materialize", "tmetrics",
]

# the metrics the finite-frontier watch trips on: a non-finite update
# or error-feedback norm means corruption reached the server state
WATCHED_METRICS = ("update_l2", "error_l2")


class NumericTripError(RuntimeError):
    """A watched telemetry metric went non-finite. Raised by the
    session after the `numeric_trip` journal event is durable."""

    def __init__(self, round_idx: int, metrics=()):
        super().__init__(
            f"non-finite {'/'.join(metrics) or 'telemetry'} at round "
            f"{round_idx}: value corruption reached the server state")
        self.round_idx = int(round_idx)
        self.metrics = tuple(metrics)


def materialize(x) -> np.ndarray:
    """A round's tensor on the host. On the card the copy waits for the
    work queued on the stream, the round just dispatched included; the
    drivers' one-round-late metric emit waits for the same round."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def attach_run_telemetry(model, cfg, log_dir: str, driver: str,
                         materialize: Callable = materialize):
    """Build and attach a run's TelemetrySession (both drivers): the
    journal at cfg.journal_path or <log_dir>/journal.jsonl, the model's
    throughput tracker, the stage tracer under --trace. Journals
    `run_start` and returns the session (the caller closes it), or None
    under --no_telemetry."""
    if not cfg.telemetry:
        return None
    jpath = cfg.journal_path or os.path.join(log_dir or ".",
                                             "journal.jsonl")
    journal = RunJournal(jpath, run_id=log_dir or driver,
                         async_writer=bool(cfg.pipeline))
    tele = TelemetrySession(journal=journal, tracker=model.throughput,
                            materialize=materialize,
                            trace=bool(cfg.trace))
    model.attach_telemetry(tele)
    tele.journal_event(
        "run_start", driver=driver, mode=cfg.mode, trace=bool(cfg.trace),
        dataset=cfg.dataset_name, num_workers=cfg.num_workers,
        num_clients=model.num_clients, grad_size=model.cfg.grad_size,
        kernel_backend=cfg.kernel_backend,
        sketch_table_dtype=cfg.sketch_table_dtype,
        state_tier=cfg.state_tier,
        state_working_set=int(cfg.state_working_set),
        scan_rounds=bool(cfg.scan_rounds),
        transfer_guard=bool(cfg.debug_transfer_guard),
        resumed_round=int(model.server.round_idx))
    return tele


class TelemetrySession:
    """Host-side telemetry conductor for one run.

    journal: RunJournal or None; tracker: ClientThroughputTracker or
    None (FedModel.attach_telemetry fills in the model's own);
    materialize: device -> host function for the buffered tensors;
    trace: enable the global stage tracer for this run (disabled again
    at close)."""

    def __init__(self, journal: Optional[RunJournal] = None,
                 tracker: Optional[ClientThroughputTracker] = None,
                 materialize: Callable = materialize,
                 clock: Callable[[], float] = time.monotonic,
                 trace: bool = False, controller: int = 0):
        self.journal = journal
        self.tracker = tracker
        self._owns_trace = bool(trace)
        if trace:
            TRACE.enable(controller=controller)
        self._materialize = materialize
        self._clock = clock
        # (round_idx, ids, vec, counts, t, comm, scheduled) of the
        # round waiting for its successor
        self._pending = None
        self._closed = False
        self._journal_warned = False
        self._cum_down_bytes = 0.0
        self._cum_up_bytes = 0.0
        self._comm_seen = False

    def _safe_write(self, write: Callable[[], object]) -> None:
        """A failed journal append (disk full, a field json cannot
        serialize) warns once and training continues."""
        try:
            write()
        except (OSError, TypeError, ValueError) as e:
            if not self._journal_warned:
                print(f"telemetry: journal write failed ({e}); "
                      f"training continues, further failures silent")
                self._journal_warned = True

    def journal_event(self, kind: str, /, **fields) -> None:
        if self.journal is not None:
            self._safe_write(lambda: self.journal.event(kind, **fields))

    def _flush_trace(self) -> None:
        """Drain the tracer's rings into ONE `trace` journal event."""
        if not TRACE.enabled:
            return
        spans, dropped = TRACE.drain()
        if (not spans and not dropped) or self.journal is None:
            return
        fields = {"controller": TRACE.controller, "spans": spans}
        if dropped:
            fields["dropped"] = int(dropped)
        self._safe_write(lambda: self.journal.event("trace", **fields))

    def mark_steady_state(self) -> None:
        """Kept for call parity with the JAX drivers, which journal
        every XLA compile after this point as a `compile_warning`. The
        port compiles no round program, so there is nothing to watch."""

    def on_round(self, round_idx: int, client_ids, telemetry_vec,
                 num_examples, comm=None, scheduled=None) -> None:
        """Buffer one round's metric tensors; materialize and journal
        the PREVIOUS round. comm: optional (download, upload) byte
        totals of the round; scheduled: optional [W] mask of the
        tracker's slots."""
        now = self._clock()
        prev, self._pending = self._pending, (
            int(round_idx), np.asarray(client_ids), telemetry_vec,
            num_examples, now, comm, scheduled)
        if prev is not None:
            self._emit_round(prev, now - prev[4])

    def _record_comm(self, fields: dict, comm) -> None:
        if comm is None:
            return
        down, up = float(comm[0]), float(comm[1])
        self._cum_down_bytes += down
        self._cum_up_bytes += up
        self._comm_seen = True
        fields["down_bytes"] = down
        fields["up_bytes"] = up

    def _emit_round(self, rec, seconds: Optional[float]) -> None:
        round_idx, ids, vec, counts, _, comm, scheduled = rec
        counts_h = np.asarray(self._materialize(counts))
        if (self.tracker is not None and seconds is not None
                and seconds > 0):
            self.tracker.update_round(ids, counts_h, seconds,
                                      scheduled=scheduled)
        named = tmetrics.named(
            None if vec is None else np.asarray(
                self._materialize(vec), np.float32))
        if self.journal is not None:
            fields = {"round": round_idx}
            if named:
                fields["metrics"] = named
            if seconds is not None:
                fields["seconds"] = round(seconds, 6)
            self._record_comm(fields, comm)
            self.journal_event("round", **fields)
        elif comm is not None:
            self._record_comm({}, comm)
        self._flush_trace()
        self._check_trip(round_idx, named)

    def _check_trip(self, round_idx: int, named) -> None:
        """A non-finite watched metric journals a durable
        `numeric_trip` and raises NumericTripError; disarmed once the
        session is closing."""
        if not named or self._closed:
            return
        bad = [k for k in WATCHED_METRICS
               if k in named and not np.isfinite(named[k])]
        if not bad:
            return
        self.journal_event("numeric_trip", round=int(round_idx),
                           metrics=bad)
        self.journal_flush()
        raise NumericTripError(round_idx, bad)

    def discard_pending(self) -> None:
        """Drop the one-round-lag buffer without journaling it (the
        tripped round's successor would trip again)."""
        self._pending = None

    def flush(self) -> None:
        """Journal the buffered round (without `seconds`: it has no
        successor to time it against) and flush the tracer."""
        prev, self._pending = self._pending, None
        if prev is not None:
            self._emit_round(prev, None)
        self._flush_trace()
        self.journal_flush()

    def journal_flush(self) -> None:
        """Barrier the journal only (its records are durable already:
        the port's journal writes synchronously)."""
        if self.journal is not None:
            self._safe_write(self.journal.flush)

    def close(self, **fields) -> None:
        """Drain the buffer and journal `run_end` with `fields` and the
        run's cumulative byte totals."""
        if self._closed:
            return
        self._closed = True
        self.flush()
        if self.journal is not None:
            if self._comm_seen:
                fields.setdefault("down_bytes_total",
                                  self._cum_down_bytes)
                fields.setdefault("up_bytes_total", self._cum_up_bytes)
            self.journal_event("run_end", **fields)
            self.journal.close()
        if self._owns_trace:
            TRACE.disable()
