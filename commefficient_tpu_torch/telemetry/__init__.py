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

On the scanned-span path (training/scanloop.py) `on_span` takes a
whole span's host rows at its collect and journals one `span` record
and the span's `round` records in one append; `span_profile_begin` /
`span_profile_end` run torch.profiler over the span indices of
`--profile_spans A:B` and write its Chrome trace under
`<log dir>/profile_spans`. The port compiles nothing, so it journals
no `compile` events.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from commefficient_tpu_torch.hooks import explicit_transfer
from commefficient_tpu_torch.telemetry import metrics as tmetrics
from commefficient_tpu_torch.telemetry.clients import ClientThroughputTracker
from commefficient_tpu_torch.telemetry.journal import RunJournal, append_event
from commefficient_tpu_torch.telemetry.trace import TRACE

__all__ = [
    "ClientThroughputTracker", "NumericTripError", "RunJournal",
    "TRACE", "TelemetrySession", "append_event", "attach_run_telemetry",
    "materialize", "parse_profile_spans", "tmetrics",
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


def parse_profile_spans(spec: str) -> Optional[Tuple[int, int]]:
    """`--profile_spans A:B` as the half-open span-index range (A, B),
    or None for the empty spec; ValueError on a malformed one."""
    if not spec:
        return None
    lo, sep, hi = spec.partition(":")
    try:
        if not sep:
            raise ValueError
        a, b = int(lo), int(hi)
    except ValueError:
        raise ValueError(
            f"--profile_spans expects 'A:B' (half-open span indices, "
            f"e.g. '2:4'), got {spec!r}") from None
    if a < 0 or b <= a:
        raise ValueError(
            f"--profile_spans {spec!r}: need 0 <= A < B")
    return a, b


def materialize(x) -> np.ndarray:
    """A round's tensor on the host. On the card the copy waits for the
    work queued on the stream, the round just dispatched included; the
    drivers' one-round-late metric emit waits for the same round."""
    if isinstance(x, torch.Tensor):
        with explicit_transfer("telemetry: a round's metrics, one round "
                               "late"):
            return x.detach().cpu().numpy()
    return np.asarray(x)


def attach_run_telemetry(model, cfg, log_dir: str, driver: str,
                         materialize: Callable = materialize,
                         coord: bool = True):
    """Build and attach a run's TelemetrySession (both drivers): the
    journal at cfg.journal_path or <log_dir>/journal.jsonl (on the
    coordinator only, `coord`: the other ranks' sessions journal
    nothing), the model's throughput tracker, the stage tracer under
    --trace. Journals `run_start` and returns the session (the caller
    closes it), or None under --no_telemetry."""
    if not cfg.telemetry:
        return None
    journal = None
    if coord:
        jpath = cfg.journal_path or os.path.join(log_dir or ".",
                                                 "journal.jsonl")
        # --pipeline: the appends ride a writer thread
        journal = RunJournal(jpath, run_id=log_dir or driver,
                             async_writer=bool(cfg.pipeline),
                             drain_timeout=float(cfg.writer_drain_timeout_s))
    tele = TelemetrySession(
        journal=journal, tracker=model.throughput,
        profile_spans=cfg.profile_spans,
        profile_dir=os.path.join(log_dir or ".", "profile_spans"),
        profile_cuda=model.device.type == "cuda",
        materialize=materialize, trace=bool(cfg.trace))
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
    profile_spans: the `--profile_spans` spec ("" = no capture), traced
    into `profile_dir` (CUDA activity too when `profile_cuda`);
    materialize: device -> host function for the buffered tensors;
    trace: enable the global stage tracer for this run (disabled again
    at close)."""

    def __init__(self, journal: Optional[RunJournal] = None,
                 tracker: Optional[ClientThroughputTracker] = None,
                 profile_spans: str = "",
                 profile_dir: str = "profile_spans",
                 profile_cuda: bool = False,
                 materialize: Callable = materialize,
                 clock: Callable[[], float] = time.monotonic,
                 trace: bool = False, controller: int = 0):
        self.journal = journal
        self.tracker = tracker
        self._spans = parse_profile_spans(profile_spans)
        self._profile_dir = profile_dir
        self._profile_cuda = bool(profile_cuda)
        self._profiler = None
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
        """Barrier the journal only, leaving the one-round-lag buffer
        alone (a no-op for the synchronous writer)."""
        if self.journal is not None:
            self._safe_write(self.journal.flush)

    # ---------------- span path (FedModel.collect_rounds) ----------------
    def on_span(self, first_round: int, ids_rows: np.ndarray,
                telemetry_rows: Optional[np.ndarray],
                counts_rows: np.ndarray,
                dispatch_s: float, block_s: float,
                comm_rows=None, scheduled_rows=None) -> None:
        """Consume one collected span: host [N, W] ids and counts and
        [N, M] metric rows (None without telemetry). Journals one `span`
        record and a `round` record a round in ONE append, feeds the
        tracker the span's wall time amortized over its rounds, flushes
        the tracer, and trips on the first non-finite watched metric in
        round order. comm_rows: per-round (download, upload) totals;
        scheduled_rows: per-round [W] masks (or None) whose zero slots
        are idle scheduler pads, kept out of the tracker."""
        # a buffered per-round record is older: journal it first
        self.flush()
        n = int(np.asarray(ids_rows).shape[0])
        per_round_s = (dispatch_s + block_s) / max(n, 1)
        if self.tracker is not None:
            for i in range(n):
                self.tracker.update_round(
                    ids_rows[i], counts_rows[i], per_round_s,
                    scheduled=(None if scheduled_rows is None
                               else scheduled_rows[i]))
        named_rows = [None if telemetry_rows is None else tmetrics.named(
            np.asarray(telemetry_rows[i], np.float32)) for i in range(n)]
        if self.journal is not None:
            batch = [("span", {"first_round": int(first_round),
                               "rounds": n,
                               "dispatch_s": round(dispatch_s, 6),
                               "block_s": round(block_s, 6)})]
            for i in range(n):
                fields = {"round": int(first_round) + i,
                          "seconds": round(per_round_s, 6)}
                if named_rows[i]:
                    fields["metrics"] = named_rows[i]
                if comm_rows is not None:
                    self._record_comm(fields, comm_rows[i])
                batch.append(("round", fields))
            self._safe_write(lambda: self.journal.events(batch))
        elif comm_rows is not None:
            for comm in comm_rows:
                self._record_comm({}, comm)
        self._flush_trace()
        for i in range(n):
            self._check_trip(int(first_round) + i, named_rows[i])

    # ---------------- --profile_spans -------------------------------------
    def span_profile_begin(self, span_idx: int) -> None:
        """Start torch.profiler as span `span_idx` enters the [A, B)
        window (scanloop calls this before each span's dispatch); one
        capture covers the whole window."""
        if (self._spans is None or self._profiler is not None
                or not self._spans[0] <= span_idx < self._spans[1]):
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self._profile_cuda:
            acts.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=acts)
        self._profiler.start()
        self.journal_event("profile_start", span=span_idx,
                           dir=self._profile_dir)

    def span_profile_end(self, span_idx: int) -> None:
        """Stop the capture once the window's last span is collected
        (its results on the host, so the trace holds its device work)
        and write its Chrome trace."""
        if self._profiler is None or span_idx < self._spans[1] - 1:
            return
        self._stop_profile(span_idx)

    def _stop_profile(self, span_idx: int) -> None:
        prof, self._profiler = self._profiler, None
        prof.stop()
        os.makedirs(self._profile_dir, exist_ok=True)
        a, b = self._spans
        prof.export_chrome_trace(os.path.join(
            self._profile_dir, f"spans_{a}_{b}.json"))
        self.journal_event("profile_stop", span=span_idx,
                           dir=self._profile_dir)

    def close(self, **fields) -> None:
        """Drain the buffer, stop a live capture and journal `run_end`
        with `fields` and the run's cumulative byte totals."""
        if self._closed:
            return
        self._closed = True
        self.flush()
        if self._profiler is not None:
            self._stop_profile(-1)
        if self.journal is not None:
            if self._comm_seen:
                fields.setdefault("down_bytes_total",
                                  self._cum_down_bytes)
                fields.setdefault("up_bytes_total", self._cum_up_bytes)
            self.journal_event("run_end", **fields)
            self.journal.close()
        if self._owns_trace:
            TRACE.disable()
