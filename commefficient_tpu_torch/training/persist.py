"""What both drivers share around their training loops: `--resume`,
the per-epoch rotated checkpoint, the final checkpoint, the run's
telemetry session, the numeric trip's rollback, `--profile` and
`--tensorboard`. The port of the matching parts of
commefficient_tpu/training/{cv_train,gpt2_train,scanloop}.py.

Under --pipeline the span checkpoints are written by the model's
writer thread: every synchronous save and the rollback drain it first,
and `close` drains it on the way out, a crash included.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional, Tuple

import torch

from commefficient_tpu_torch.parallel import multihost as mh
from commefficient_tpu_torch.telemetry import (
    NumericTripError, attach_run_telemetry,
)
from commefficient_tpu_torch.telemetry.trace import TRACE
from commefficient_tpu_torch.utils.checkpoint import (
    load_resilient, save_final, save_rotating,
)


def _state_kwargs(model, lr_scheduler) -> dict:
    """Everything a checkpoint carries besides the server state: the
    client rows as the O(cohort) payload, else the dense blocks
    (gathered over the ranks in a multi-rank run: collective, so every
    rank saves)."""
    rows = model.client_rows_payload()
    return dict(clients=model.checkpoint_clients() if rows is None
                else None,
                scheduler_step=lr_scheduler.step_count,
                accountant=model.accountant,
                prev_change_words=model._prev_change_words,
                fingerprint=model.checkpoint_fingerprint,
                throughput=model.throughput.state_dict(),
                scheduler=model.scheduler_state(),
                sampler=model.sampler_state(),
                async_admit=model.async_admit_state(),
                client_rows=rows)


def resume(model, lr_scheduler, prefix: str,
           fallbacks: List[Tuple[str, str]],
           journal_path: str = "") -> Optional[str]:
    """--resume: load the newest good checkpoint of `prefix` into the
    model (falling back past corrupt files, each appended to
    `fallbacks` as (path, reason)) and the LR schedule's step. Attach
    the run's sampler before this, so its stream is restored too. With
    a plan transport and a `journal_path`, the crashed run's
    write-ahead plan stream is loaded after it (the deterministic
    restart: FedModel.load_plan_stream). Returns the file loaded, or
    None when there is none."""
    loaded = load_resilient(
        prefix, expect_fingerprint=model.checkpoint_fingerprint,
        on_fallback=lambda p, why: fallbacks.append((p, why)))
    path = None
    if loaded is not None:
        path, ckpt = loaded
        lr_scheduler.load_state_dict({"step_count": model.load_state(ckpt)})
        if mh.is_coordinator():
            print(f"resumed from {path} at round "
                  f"{int(ckpt.server.round_idx)}")
    if model.plan_transport is not None and journal_path:
        model.load_plan_stream(journal_path)
    return path


def start_telemetry(model, cfg, log_dir: str, driver: str,
                    fallbacks=()):
    """The run's TelemetrySession (None under --no_telemetry), with the
    resume's fallbacks journaled as `checkpoint_fallback` events."""
    # every rank has a session (its numeric trips raise on every rank);
    # the coordinator alone journals
    tele = attach_run_telemetry(model, cfg, log_dir, driver=driver,
                                coord=mh.is_coordinator())
    if tele is not None:
        for p, why in fallbacks:
            tele.journal_event("checkpoint_fallback", path=p,
                               error=why[:200])
    return tele


def checkpoint_epoch(model, lr_scheduler, prefix: str, cfg,
                     round_idx: int) -> str:
    """--checkpoint_every: the rotated save inside a `checkpoint` span,
    journaled as a `checkpoint` event with its seconds and bytes."""
    t0 = time.monotonic()
    # queued span saves land before this one rotates the manifest
    model.drain_persistence()
    with TRACE.span("checkpoint", round=int(round_idx)):
        path = save_rotating(prefix, model.server,
                             keep_last=cfg.keep_checkpoints,
                             max_age_hours=cfg.ckpt_max_age_hours,
                             **_state_kwargs(model, lr_scheduler))
    if not mh.is_coordinator():
        return path
    if model.telemetry is not None:
        model.telemetry.journal_event(
            "checkpoint", path=path,
            seconds=round(time.monotonic() - t0, 3),
            bytes=os.path.getsize(path))
    print(f"checkpointed to {path}")
    return path


def checkpoint_final(model, lr_scheduler, prefix: str, cfg) -> str:
    """--checkpoint: the rotated save plus the fixed `<prefix>.npz`."""
    model.drain_persistence()
    path = save_final(prefix, model.server,
                      keep_last=cfg.keep_checkpoints,
                      max_age_hours=cfg.ckpt_max_age_hours,
                      **_state_kwargs(model, lr_scheduler))
    if mh.is_coordinator():
        print(f"saved checkpoint to {path}")
    return path


def numeric_rollback(model, prefix: str, cfg, tele,
                     trip: NumericTripError) -> Optional[int]:
    """After a numeric trip (its `numeric_trip` event already durable):
    load the newest checkpoint whose manifest records finite state,
    falling back past the others (each journaled as a
    `checkpoint_fallback` event), and force update screening on for the
    next --rollback_screen_rounds rounds, so the replayed rounds draw
    the identical poison and screen it out. Returns the restored
    scheduler step for the caller, which re-enters its loop; None when
    no finite checkpoint exists (the caller re-raises the trip)."""
    model.drain_persistence()
    if tele is not None:
        # the buffered round carries the same non-finite row and would
        # trip again at once
        tele.discard_pending()
    fallbacks: List[Tuple[str, str]] = []
    loaded = load_resilient(
        prefix, expect_fingerprint=model.checkpoint_fingerprint,
        on_fallback=lambda p, why: fallbacks.append((p, why)),
        require_finite=True)
    if tele is not None:
        for p, why in fallbacks:
            tele.journal_event("checkpoint_fallback", path=p,
                               error=why[:200])
    if loaded is None:
        return None
    path, ckpt = loaded
    step = model.load_state(ckpt)
    # after load_state: the window counts from the restored round
    model.force_screen_rounds(cfg.rollback_screen_rounds)
    if mh.is_coordinator():
        print(f"numeric trip at round {trip.round_idx} "
              f"({', '.join(trip.metrics) or 'telemetry'}): rolled back to "
              f"{path} (round {int(ckpt.server.round_idx)}); update "
              f"screening forced for {cfg.rollback_screen_rounds} rounds")
    return step


def train_with_rollback(train, model, lr_scheduler, prefix: str, cfg,
                        tele):
    """Run `train()` until it returns, rolling back on each numeric trip
    (numeric_rollback) up to --max_numeric_rollbacks times; past that,
    or with no finite checkpoint, the trip re-raises."""
    trips = 0
    while True:
        try:
            return train()
        except NumericTripError as trip:
            trips += 1
            if trips > cfg.max_numeric_rollbacks:
                raise
            step = numeric_rollback(model, prefix, cfg, tele, trip)
            if step is None:
                raise
            lr_scheduler.load_state_dict({"step_count": step})


def close(model, tele, ok) -> None:
    """The drivers' way out, whatever happened: drain and stop the
    checkpoint writer (a queued span save lands at a crash as at a
    clean end), then close the telemetry session (`run_end`)."""
    try:
        model.close_persistence()
    finally:
        if tele is not None:
            tele.close(ok=bool(ok))


class EpochProfile:
    """--profile: torch.profiler over the first trained epoch (CUDA
    activity on the card), its Chrome trace written to
    <log_dir>/profile/trace.json."""

    def __init__(self, log_dir: str, device: torch.device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.dir = os.path.join(log_dir or ".", "profile")
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self) -> str:
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, "trace.json")
        self.prof.export_chrome_trace(path)
        print(f"profile trace written to {path}")
        return path


def transfer_guard(model, cfg):
    """--debug_transfer_guard: a factory of the implicit-sync guard
    (analysis/runtime.forbid_transfers) on the model's device, which the
    drivers arm around every round (or span) after the first; None
    without the flag."""
    if not cfg.debug_transfer_guard:
        return None
    from commefficient_tpu_torch.analysis.runtime import forbid_transfers
    return lambda: forbid_transfers(model.device)


def try_tensorboard(log_dir: str):
    """A SummaryWriter, or None (with a note) when tensorboard is not
    installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(log_dir=log_dir or ".")
    # broad by necessity: tensorboard/protobuf version skew raises
    # AttributeError or TypeError, not only ImportError
    except Exception as e:  # graftlint: disable=GL005 -- optional-dep probe
        print(f"tensorboard unavailable ({e}); continuing without")
        return None
