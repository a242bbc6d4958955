"""The span loop of --scan_rounds: the port of
commefficient_tpu/training/scanloop.py.

`run_scanned_rounds` collects a round stream into spans of `span_cap`
rounds (the last may be shorter), stages each span on the host as
[N, W, B, ...] and runs it through FedModel.run_rounds, then emits the
span's per-round metric rows. Both drivers use it; what they do with a
round's rows is their `emit`. Under --scan_span_palette `span_cap` is
the model's ControllerBank: each span's length is its pick as the span's
first round is drawn, and the stream's tail is cut into palette lengths
(control/span.py).

With `pipeline=True` (--pipeline) a span is DISPATCHED as soon as it is
staged (FedModel.dispatch_rounds, which queues its rounds on the card
and returns) and COLLECTED one flush later (FedModel.collect_rounds:
accounting, journal, the boundary checkpoint, the emits), and a staging
thread runs the stream (sampler draws, batch fetch and transform, the
LR step, stacking) one span ahead: the host's batch making overlaps the
loop's dispatch and collect, and the card's work on the span before.
The synchronous path runs the same halves back to back on one thread.
With controllers (the adaptive screen or a bank), whose stamps at draw
time read what collects feed them, the staging thread draws span s only
once span s - 2 is collected, as the JAX loop's order has it (_Gate):
the stamps, the span pick and the span's stream cursor then see the same
collected state on every run, whatever the threads' timing.

There is no scanned device program in the port: a span's rounds are
the per-round path's, operation for operation, so a spanned or
pipelined run gives the plain loop's weights, client rows, metrics and
billed bytes bitwise. The span is the unit of commit and of overlap.

`make_span_checkpoint` builds the span-boundary checkpoint hook
(--ckpt_every_spans). The numeric rollback is training/persist.py's.
"""
from __future__ import annotations

import contextlib
import queue
import threading
import time
from typing import Callable, Iterable, Optional, Tuple

import numpy as np


def run_scanned_rounds(model, stream: Iterable[Tuple], span_cap,
                       emit: Callable[..., bool],
                       on_comm: Optional[Callable[[float, float],
                                                  None]] = None,
                       on_flush: Optional[Callable[[int], None]] = None,
                       checkpoint: Optional[Callable[..., None]] = None,
                       pipeline: bool = False,
                       guard: Optional[Callable] = None) -> bool:
    """Drive spans of at most `span_cap` rounds over `stream`, which
    yields (tag, client_ids, data_tuple, mask, lr) a round; the caller
    ends the stream at its round budget. `span_cap` is an int, or a
    provider with span_cap(default) (each span's length, read as its
    first round is drawn) and tail_cap(leftover) (the stream's tail is
    cut into spans of those lengths).

    Per span, once it is collected: on_flush(n_rounds), then
    on_comm(download, upload) with the span's byte totals, then
    checkpoint(), then emit(tag, *per_round_metric_rows) once a round
    in order. An emit returning False aborts at once (the span's later
    rounds are neither emitted nor logged, as the plain loop stops at
    its first bad round).

    `checkpoint` is the span-boundary hook: a span is the unit of
    commit (a crash while it runs loses it whole,
    FaultSchedule.crash_in_span), so a save at each boundary, after the
    span's state and accounting committed and before emits that might
    abort, bounds what a crash loses to one span.

    A model with a telemetry session also gets the --profile_spans
    capture around the selected span indices (counted on the model,
    `_spans_dispatched`, across the drivers' per-epoch calls).

    `pipeline=True` defers each span's commit (on_flush, on_comm,
    checkpoint, emits) to the next flush, after the following span is
    dispatched, and the stream runs on a staging thread one span ahead
    (_StagingThread). An emit abort then lands one span late, with the
    next span already run: drain_pending_on_abort collects its
    accounting and skips its emits and its checkpoint. The checkpoint
    hook gets the snapshot of its span's own boundary through its
    `snapshot` keyword: the model's part (`.snapshot`, the state and
    client rows copied right after the span's dispatch) and the
    stream's (`.cursor`, the sampler and the LR step as the span's last
    round was drawn, before the staging thread draws the next span).

    `guard` is the --debug_transfer_guard hook (persist.transfer_guard):
    a factory of the implicit-sync guard armed around every span's
    dispatch but the model's first.

    Returns True if every emit succeeded, False on an abort."""
    snapshot_fn = getattr(checkpoint, "snapshot", None)
    cursor_fn = getattr(checkpoint, "cursor", None) if pipeline else None
    # pipelined: the one dispatched, uncollected span
    pending = []  # [(handle, tags, span_idx, snapshot)]
    tele = getattr(model, "telemetry", None)
    gate = (_Gate() if pipeline and (
        getattr(model, "control_bank", None) is not None
        or getattr(model, "screen_ctl", None) is not None) else None)

    def commit(out, span_tags, snap) -> bool:
        *metric_rows, down, up = out
        if on_flush is not None:
            on_flush(len(span_tags))
        if on_comm is not None:
            on_comm(down, up)
        if checkpoint is not None:
            if snap is not None:
                checkpoint(snapshot=snap)
            else:
                checkpoint()
        for n in range(len(span_tags)):
            if not emit(span_tags[n], *[m[n] for m in metric_rows]):
                return False
        return True

    def collect_pending():
        handle, span_tags, span_idx, snap = pending.pop()
        out = model.collect_rounds(handle)
        if gate is not None:
            gate.collected()
        if tele is not None:
            tele.span_profile_end(span_idx)
        return out, span_tags, snap

    def drain_pending_on_abort() -> None:
        """After an abort with a span still in flight: commit its
        accounting and telemetry, so the model's accountant and change
        bits match its (already advanced) weights; no emits and no
        boundary checkpoint of a post-abort state."""
        if not pending:
            return
        out, span_tags, _ = collect_pending()
        *_, down, up = out
        if on_flush is not None:
            on_flush(len(span_tags))
        if on_comm is not None:
            on_comm(down, up)

    def flush(span_tags, args, cursor) -> bool:
        span_idx = model._spans_dispatched
        if tele is not None:
            tele.span_profile_begin(span_idx)
        # --debug_transfer_guard: every span after the model's first is
        # dispatched (and, synchronously, collected) under the guard; the
        # span index lives on the model, as the drivers call this once an
        # epoch
        ctx = (guard() if guard is not None and span_idx > 0
               else contextlib.nullcontext())
        if not pipeline:
            with ctx:
                out = model.run_rounds(*args)
            if tele is not None:
                tele.span_profile_end(span_idx)
            model._spans_dispatched = span_idx + 1
            return commit(out, span_tags, None)
        # a crash boundary in the pending span surfaces before more work
        # is dispatched (its collect raises InjectedFault)
        if pending and pending[0][0].crash_at is not None:
            collect_pending()
        with ctx:
            handle = model.dispatch_rounds(*args)
        model._spans_dispatched = span_idx + 1
        # this span's boundary; the stream's side of it (the sampler's
        # cursor, the LR step) was taken as its last round was drawn
        snap = snapshot_fn() if snapshot_fn is not None else None
        if snap is not None and cursor is not None:
            snap.update(cursor)
        prev_ok = True
        if pending:
            prev_ok = commit(*collect_pending())
        if snap is not None:
            # the tracker commits at collect: after the previous span's
            # collect it holds what the next span's draws observe
            snap["throughput"] = model.throughput.state_dict()
        pending.append((handle, span_tags, span_idx, snap))
        return prev_ok

    if hasattr(span_cap, "span_cap"):
        caps = (lambda: int(span_cap.span_cap(1)), span_cap.tail_cap)
    else:
        caps = (lambda: int(span_cap), None)
    spans = _spans(stream, *caps, cursor_fn, gate)
    staging = _StagingThread(spans, gate) if pipeline else None
    try:
        for span_tags, args, cursor in (staging or spans):
            if not flush(span_tags, args, cursor):
                drain_pending_on_abort()
                return False
    finally:
        if staging is not None:
            staging.stop()
    if pending:
        return commit(*collect_pending())
    return True


def _spans(stream, cap_fn, tail_fn=None, cursor_fn=None, gate=None):
    """The stream's rounds in spans, each as (tags, run_rounds' arguments
    stacked [N, ...], the stream's cursor right after the span's last
    draw, or None). A span's length is cap_fn() as its first round is
    drawn; the stream's tail is one span, or with `tail_fn` spans of
    tail_fn(leftover) rounds. With a `gate`, span s is drawn (or, in the
    tail, cut) only once gate.wait(s) lets it."""

    def pack(rounds):
        tags, ids, datas, masks, lrs = zip(*rounds)
        args = (np.stack(ids),
                tuple(np.stack([d[i] for d in datas])
                      for i in range(len(datas[0]))),
                np.stack(masks), list(lrs))
        return (list(tags), args,
                cursor_fn() if cursor_fn is not None else None)

    it = iter(stream)
    span = 0
    rounds = []
    while True:
        if gate is not None and not gate.wait(span):
            return
        cap = None
        for item in it:
            rounds.append(item)
            if cap is None:
                cap = cap_fn()
            if len(rounds) >= cap:
                break
        if cap is not None and len(rounds) >= cap:
            yield pack(rounds)
            span += 1
            rounds = []
            continue
        # the stream ended
        while rounds:
            take = (max(1, min(int(tail_fn(len(rounds))), len(rounds)))
                    if tail_fn is not None else len(rounds))
            yield pack(rounds[:take])
            span += 1
            rounds = rounds[take:]
            if rounds and gate is not None and not gate.wait(span):
                return
        return


class _Gate:
    """--pipeline's order with controllers: the staging thread draws
    span s only once the loop has collected span s - 2 (the JAX loop
    draws span s after the flush of span s - 1, which collects s - 2).
    A stopped gate lets no more spans be drawn."""

    def __init__(self):
        self._cond = threading.Condition()
        self._collected = 0
        self._stopped = False

    def wait(self, span: int) -> bool:
        with self._cond:
            self._cond.wait_for(lambda: self._stopped
                                or self._collected >= span - 1)
            return not self._stopped

    def collected(self) -> None:
        with self._cond:
            self._collected += 1
            self._cond.notify_all()

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()


class _StagingThread:
    """--pipeline's staging: a thread runs the span generator (the
    driver's stream: sampler draws, batch fetch and transform, the LR
    step, then the stacking) one span ahead of the round loop, so the
    host's batch making overlaps the loop's dispatch and collect and
    the card's work. Iterating yields the spans in order; an exception
    of the stream re-raises here, on the loop's thread."""

    _END = object()

    def __init__(self, spans, gate: Optional[_Gate] = None):
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._gate = gate
        self._stopping = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(spans,),
                                        name="span-staging", daemon=True)
        self._thread.start()

    def _run(self, spans) -> None:
        try:
            for span in spans:
                if not self._put(span):
                    return
            self._put(self._END)
        # handed to the loop's thread, which re-raises it
        except BaseException as e:  # graftlint: disable=GL005 -- re-raised on the loop's thread
            self._put(_Raised(e))

    def _put(self, item) -> bool:
        while not self._stopping.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._END:
                return
            if isinstance(item, _Raised):
                raise item.exc
            yield item

    def stop(self) -> None:
        """Stop staging (an abort or a crash leaves spans undrawn) and
        wait for the thread."""
        self._stopping.set()
        if self._gate is not None:
            self._gate.stop()
        self._thread.join()


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


def make_span_checkpoint(prefix: str, model, cfg, lr_scheduler):
    """The drivers' span-boundary `checkpoint` hook for
    run_scanned_rounds: a rotated save (utils/checkpoint.save_rotating)
    at every cfg.ckpt_every_spans-th boundary, or None when
    checkpointing is off (checkpoint_every 0) or the cadence is 0
    (epoch saves only).

    Its `.snapshot` attribute takes the boundary state for a save made
    one span late (--pipeline): FedModel.state_snapshot's host copies of
    the server state and the client rows, queued behind the span's own
    rounds (the next span writes the live rows in place; under the
    tiered store the resident rows and the LRU bookkeeping), and the
    pending async admissions (composed at dispatch); its `.cursor` the
    LR step, the sampler's cursor and the scheduler's state as of the
    span's draws (the staging thread takes it). The accountant and
    the change bits commit at collect in span order, so they are read
    live at save time. Under --pipeline the file is written by the
    model's AsyncCheckpointWriter."""
    if not (cfg.checkpoint_every and cfg.ckpt_every_spans):
        return None
    from commefficient_tpu_torch.parallel import multihost as mh
    from commefficient_tpu_torch.telemetry.trace import TRACE
    from commefficient_tpu_torch.utils.checkpoint import save_rotating

    spans_done = [0]

    def stream_cursor() -> dict:
        return {"scheduler_step": lr_scheduler.step_count,
                "sampler": model.sampler_state(),
                "scheduler": model.scheduler_state()}

    def take_snapshot() -> dict:
        return {"state": model.state_snapshot(),
                "async_admit": model.async_admit_state(),
                **stream_cursor()}

    def span_checkpoint(snapshot=None):
        spans_done[0] += 1
        if spans_done[0] % cfg.ckpt_every_spans:
            return
        if snapshot is None:
            snapshot = take_snapshot()
        bank = getattr(model, "control_bank", None)
        if bank is not None and bank.commit_state_dict():
            # commit-time controller state (the staleness ring) advances
            # at collect, in span order: by now this span has collected,
            # so its live value is the boundary's (the accountant's rule)
            snapshot["scheduler"] = {**(snapshot["scheduler"] or {}),
                                     **bank.commit_state_dict()}
        t0 = time.monotonic()
        server, rows = model.wait_snapshot(snapshot["state"])
        dense = rows is not None and "dense" in rows
        # a stateless config's placeholders (gathered on the ranks)
        clients = (rows["dense"] if dense else
                   model.checkpoint_clients() if rows is None else None)
        with TRACE.span("checkpoint", round=int(server.round_idx)):
            path = save_rotating(
                prefix, server, clients,
                keep_last=cfg.keep_checkpoints,
                max_age_hours=cfg.ckpt_max_age_hours,
                scheduler_step=snapshot["scheduler_step"],
                accountant=model.accountant,
                prev_change_words=model._prev_change_words,
                fingerprint=model.checkpoint_fingerprint,
                throughput=snapshot.get("throughput",
                                        model.throughput.state_dict()),
                scheduler=snapshot["scheduler"],
                sampler=snapshot["sampler"],
                async_admit=snapshot["async_admit"],
                client_rows=None if dense else rows,
                writer=model.ckpt_writer)
        if model.telemetry is not None:
            # under the writer thread `seconds` is the wait for the host
            # copies and the queueing; the write itself is off the loop
            model.telemetry.journal_event(
                "checkpoint", path=path,
                seconds=round(time.monotonic() - t0, 3),
                span_boundary=True)
        if mh.is_coordinator():
            print(f"checkpointed to {path}")

    span_checkpoint.snapshot = take_snapshot
    span_checkpoint.cursor = stream_cursor
    return span_checkpoint
