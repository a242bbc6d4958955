"""The round scheduler, the port of commefficient_tpu/scheduler: who
takes part in each round (`policy`) and how long it may run
(`deadline`), conducted by `RoundScheduler`.

Per round, on the host:

  FedSampler.epoch                      FedModel._faults_for_round
  scheduler.select(alive, W, rng)  -->  plan = scheduler.take_plan(r)
  ... cursor, take and mask ...           survivors *= plan.active
  scheduler.commit_round(ids, ex)  -->    work = min(work, plan.work)

Selection runs in the data layer, the plan is keyed by the global
round index and consumed at dispatch, and its decisions enter the round
through the operands the fault paths already take: an idle slot is a
survivor zero (bitwise a dropped client, billed nothing), a deadline
truncation a work fraction (the straggler path).

The default (`--sampler uniform`, no deadline, no survivor target)
draws the scheduler-free stream, plans nothing and journals nothing.
The counters, the throughput sampler's alias snapshot and the
high-water mark of committed rounds ride in checkpoints under `sched_*`
keys, the JAX package's, so a resumed run replays the same decisions
from the restored tracker (`thr_*`) and sampler stream (`smp_*`).

FedModel shares its controllers (commefficient_tpu_torch/control) with
the scheduler: the adaptive screen (`screen_ctl`, its multiplier on
`RoundPlan.screen_mult`) and the controller bank (`control_bank`, which
stamps each fresh plan's `controls` and min-composes its work
fractions). Either makes the scheduler plan every round, and their
state rides the same `sched_*` keys.

The control plane (parallel/plantransport.py, `attach_transport`): a
policy that reads process-local state (the throughput sampler, the
deadline, the survival estimate) would diverge across controllers, so
with a transport attached the coordinator broadcasts each round's
serialized plan at `commit_round`, the plan carrying its chosen
`participants`, and every controller, the coordinator included,
installs the delivered bytes through `_install`, which cross-checks
their digest (`transport.verify`). A follower takes its selection from
the broadcast (`_recv_plan`, inside a `plan_install` trace span); a
shared-stream draw (uniform) still runs on every controller and is
held to the broadcast. On a deterministic restart `replay_plans` holds
the crashed run's journaled plans: a replayed round installs them, and
the coordinator broadcasts them again verbatim.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np

from commefficient_tpu_torch.control.screen import AdaptiveScreenController
from commefficient_tpu_torch.parallel.plantransport import (
    PlanDigestError, deserialize_plan, plan_digest, serialize_plan,
)
from commefficient_tpu_torch.scheduler.deadline import (
    DeadlineDecision, DeadlinePolicy, overprovision,
)
from commefficient_tpu_torch.scheduler.policy import (
    SAMPLERS, ParticipantSampler, ThroughputAwareSampler, UniformSampler,
    make_sampler,
)
from commefficient_tpu_torch.telemetry.clients import ClientThroughputTracker
from commefficient_tpu_torch.telemetry.trace import TRACE

__all__ = [
    "AdaptiveScreenController", "DeadlineDecision", "DeadlinePolicy",
    "ParticipantSampler", "RoundPlan", "RoundScheduler", "SAMPLERS",
    "ThroughputAwareSampler", "UniformSampler", "attach_round_scheduler",
    "overprovision",
]

# the persistent counters, in the checkpoint's order
STATE_KEYS = ("rounds_scheduled", "clients_sampled",
              "deadline_rounds", "truncated_slots", "last_deadline_s",
              "rounds_committed")


class RoundPlan(NamedTuple):
    """One round's decision, made at selection and consumed at
    dispatch."""
    round_idx: int
    n_sampled: int                     # active participant slots
    active: Optional[np.ndarray]       # [W] f32 {0,1}; None = all
    work: Optional[np.ndarray]         # [W] f32 (0,1]; None = full
    deadline_s: Optional[float]
    est_round_s: Optional[float]
    expected_round_s: Optional[float]
    sampler: str
    # the chosen ids before padding, on transport runs only: a follower
    # installs the coordinator's selection from the broadcast
    participants: Optional[np.ndarray] = None
    screen_mult: Optional[float] = None
    controls: Optional[dict] = None

    def journal_fields(self) -> dict:
        """The `schedule` event's payload (None fields left out)."""
        out = {"round": int(self.round_idx), "sampler": self.sampler,
               "n_sampled": int(self.n_sampled)}
        for name in ("deadline_s", "est_round_s", "expected_round_s"):
            v = getattr(self, name)
            if v is not None:
                out[name] = round(float(v), 6)
        if self.work is not None:
            out["truncated_slots"] = int((self.work < 1.0).sum())
        if self.screen_mult is not None:
            out["screen_mult"] = float(self.screen_mult)
        if self.controls:
            for field, value in sorted(self.controls.items()):
                out[field] = (int(value) if isinstance(value, int)
                              else float(value))
        return out


class RoundScheduler:
    """Participant sampling and the deadline policy of one run. The
    drivers build it with attach_round_scheduler and call
    `begin_epoch(first_round)` before each epoch's stream, so its round
    counter is the global round index, the resumed epoch's replayed
    head included."""

    def __init__(self, cfg, num_clients: int,
                 tracker: ClientThroughputTracker):
        self.cfg = cfg
        self.num_clients = int(num_clients)
        self.tracker = tracker
        self.policy = make_sampler(cfg, tracker)
        self.deadline = (DeadlinePolicy(tracker, cfg.deadline_quantile,
                                        min_work=cfg.deadline_min_work)
                         if cfg.deadline_quantile > 0 else None)
        self.target_survivors = int(cfg.target_survivors)
        self._next_round = 0
        self._plans: Dict[int, RoundPlan] = {}
        # rounds_committed is the high-water mark: a replayed selection
        # (the resume's skipped head, an abandoned stream tail drawn
        # again) does not count twice
        self.rounds_scheduled = 0
        self.clients_sampled = 0
        self.deadline_rounds = 0
        self.truncated_slots = 0
        self.last_deadline_s = 0.0
        self.rounds_committed = 0
        # the tiered store's host prefetch (FedModel.attach_scheduler):
        # warms the host side of a plan's coming restores; LRU-neutral
        self.state_prefetch = None
        # the model's adaptive screen and controller bank
        # (FedModel.attach_scheduler)
        self.screen_ctl = None
        self.control_bank = None
        # the control plane (module docstring): the attached transport,
        # the last selection (carried by the coordinator's plan), the
        # follower's received plan, and a restart's journaled plans
        self.transport = None
        self._last_selected: Optional[np.ndarray] = None
        self._received: Optional[RoundPlan] = None
        self.replay_plans: Dict[int, bytes] = {}

    def load_replay_plans(self, plans: Dict[int, bytes]) -> None:
        """Install a crashed run's journaled plans ({round: serialized
        plan}) for the deterministic restart's replay."""
        self.replay_plans = dict(plans)

    def attach_transport(self, transport) -> None:
        """Install a plantransport.PlanTransport (or None). It matters
        only off the default, which plans nothing."""
        self.transport = transport

    @property
    def _follower(self) -> bool:
        """A transport attached, a non-default policy and not the
        coordinator: this controller installs broadcast plans."""
        return (self.transport is not None and not self.is_default
                and not self.transport.is_coordinator)

    def _recv_plan(self, round_idx: int) -> RoundPlan:
        """A follower's receive of the round's broadcast, installed as
        delivered; idempotent (a duplicated delivery installs the same
        plan under the same round)."""
        with TRACE.span("plan_install", round=int(round_idx)):
            plan = deserialize_plan(self.transport.broadcast(round_idx))
        self._received = plan
        return plan

    def _selection_from_plan(self, plan: RoundPlan, alive, rng,
                             source: str, diverged: str) -> np.ndarray:
        """The round's participants from an installed plan (broadcast or
        journaled). A shared-stream policy still draws, so that every
        controller's rng advances alike, and its draw must equal the
        plan's or PlanDigestError is raised."""
        if plan.participants is None:
            raise PlanDigestError(
                f"round {self._next_round}: {source} carries no "
                "participants — coordinator running a pre-transport "
                "build?")
        part = np.asarray(plan.participants)
        if not self.policy.process_local:
            mine = np.asarray(self.policy.select(
                np.asarray(alive), len(part), rng, self._next_round))
            if not np.array_equal(mine, part):
                raise PlanDigestError(
                    f"round {self._next_round}: this controller's "
                    f"shared-stream draw disagrees with {source} — "
                    f"{diverged}")
        return part

    @property
    def is_default(self) -> bool:
        """Uniform sampling, no deadline, no survivor target: selects as
        the scheduler-free sampler does and plans nothing."""
        return (isinstance(self.policy, UniformSampler)
                and self.deadline is None
                and self.target_survivors == 0
                and self.screen_ctl is None
                and self.control_bank is None)

    # -- selection (FedSampler) -------------------------------------------
    def begin_epoch(self, first_round: int) -> None:
        """Set the round counter to the epoch stream about to be drawn;
        plans of an abandoned stream tail are dropped."""
        self._next_round = int(first_round)
        self._plans.clear()
        self._last_selected = None
        self._received = None

    def select(self, alive: np.ndarray, num_slots: int,
               rng) -> np.ndarray:
        """This round's active participants: over-provisioning picks the
        count (n <= num_slots), the policy the ids. The FedSampler pads
        the other slots with idle rows. A follower takes the ids and
        their count from the coordinator's broadcast; a replayed round
        from the journaled plan."""
        if self._follower:
            plan = self._recv_plan(self._next_round)
            return self._selection_from_plan(
                plan, alive, rng, source="the coordinator's broadcast",
                diverged="rng replicas diverged")
        wire = (self.replay_plans.get(self._next_round)
                if self.transport is not None else None)
        if wire is not None:
            part = self._selection_from_plan(
                deserialize_plan(wire), alive, rng,
                source="the write-ahead journaled plan",
                diverged="restored rng state diverged from the "
                         "crashed run")
            self._last_selected = np.array(part, copy=True)
            return part
        n = overprovision(self.target_survivors, int(num_slots),
                          len(alive), self._survival_estimate())
        chosen = np.asarray(self.policy.select(np.asarray(alive), n, rng,
                                               self._next_round))
        if self.transport is not None:
            # the coordinator's plan carries the selection itself
            self._last_selected = np.array(chosen, copy=True)
        return chosen

    def _survival_estimate(self) -> float:
        """The tracker's completion ratio once it has seen a round's
        worth of participations, else 1 - client_dropout."""
        part = int(self.tracker.total_participations)
        if part >= max(self.cfg.num_workers, 1):
            return float(self.tracker.total_completions) / part
        return 1.0 - float(self.cfg.client_dropout)

    def commit_round(self, client_ids: np.ndarray,
                     examples_per_slot: np.ndarray) -> None:
        """Seal one drawn round: `client_ids` the padded [W] slots, idle
        slots with zero examples. Advances the counter and, off the
        default, stores the plan dispatch takes."""
        round_idx = self._next_round
        self._next_round = round_idx + 1
        fresh = round_idx >= self.rounds_committed
        if fresh:
            self.rounds_committed = round_idx + 1
            self.rounds_scheduled += 1
        prefetching = self.state_prefetch is not None and fresh
        if prefetching or not self.is_default:
            ex = np.asarray(examples_per_slot, np.float64).reshape(-1)
            ids = np.asarray(client_ids).reshape(-1)
        if prefetching:
            self.state_prefetch(ids[ex > 0])
        if self.is_default:
            return
        if self._follower:
            # the broadcast plan, never a local computation: select
            # received it (a commit without a select receives it here)
            plan = self._received
            if plan is None or plan.round_idx != round_idx:
                plan = self._recv_plan(round_idx)
            self._received = None
            self._install(round_idx, plan, fresh)
            return
        wire = (self.replay_plans.pop(round_idx, None)
                if self.transport is not None else None)
        if wire is not None:
            # a replayed round: the journaled bytes installed and
            # broadcast again verbatim
            self._last_selected = None
            with TRACE.span("plan_install", round=int(round_idx)):
                delivered = self.transport.broadcast(round_idx, wire)
                self._install(round_idx, deserialize_plan(delivered),
                              fresh)
            return
        active = ex > 0
        n_active = int(active.sum())
        if fresh:
            self.clients_sampled += n_active
        active_mask = (None if n_active == len(ex)
                       else active.astype(np.float32))
        work = None
        decision = DeadlineDecision(None, None, None, None)
        if self.deadline is not None and n_active:
            decision = self.deadline.decide(ids[active], ex[active])
            if decision.work is not None:
                work = np.ones(len(ex), np.float32)
                work[active] = decision.work
                if fresh:
                    self.truncated_slots += int(
                        (decision.work < 1.0).sum())
            if decision.deadline_s is not None and fresh:
                self.deadline_rounds += 1
                self.last_deadline_s = float(decision.deadline_s)
        plan = RoundPlan(
            round_idx, n_active, active_mask, work,
            decision.deadline_s, decision.est_round_s,
            decision.expected_round_s, self.policy.name,
            self._last_selected if self.transport is not None else None)
        if self.screen_ctl is not None:
            plan = plan._replace(screen_mult=self.screen_ctl.plan_mult())
        if self.control_bank is not None:
            plan = self.control_bank.stamp_plan(plan, ids, ex,
                                                self.tracker)
        self._last_selected = None
        if self.transport is not None:
            # the coordinator installs the delivered bytes, as every
            # follower does
            with TRACE.span("plan_install", round=int(round_idx)):
                delivered = self.transport.broadcast(
                    round_idx, serialize_plan(plan))
                self._install(round_idx, deserialize_plan(delivered),
                              fresh=False)
            return
        self._plans[round_idx] = plan

    def _install(self, round_idx: int, plan: RoundPlan,
                 fresh: bool) -> None:
        """Install a delivered plan for take_plan: a fresh follower or
        replayed round advances the counters from the plan's fields
        (the coordinator's advanced as it computed it), and the plan's
        digest is cross-checked against every other controller's."""
        if fresh:
            self.clients_sampled += int(plan.n_sampled)
            if plan.work is not None:
                self.truncated_slots += int(
                    (np.asarray(plan.work) < 1.0).sum())
            if plan.deadline_s is not None:
                self.deadline_rounds += 1
                self.last_deadline_s = float(plan.deadline_s)
        self._plans[round_idx] = plan
        self.transport.verify(round_idx, plan_digest(plan))

    # -- dispatch (FedModel) ----------------------------------------------
    def take_plan(self, round_idx: int) -> Optional[RoundPlan]:
        """Pop round `round_idx`'s plan (None when none was made)."""
        return self._plans.pop(int(round_idx), None)

    # -- the sched_* checkpoint keys --------------------------------------
    def state_dict(self) -> dict:
        out = {
            "rounds_scheduled": np.int64(self.rounds_scheduled),
            "clients_sampled": np.int64(self.clients_sampled),
            "deadline_rounds": np.int64(self.deadline_rounds),
            "truncated_slots": np.int64(self.truncated_slots),
            "last_deadline_s": np.float64(self.last_deadline_s),
            "rounds_committed": np.int64(self.rounds_committed),
        }
        if hasattr(self.policy, "state_dict"):
            out.update(self.policy.state_dict())
        if self.screen_ctl is not None:
            out.update(self.screen_ctl.state_dict())
        if self.control_bank is not None:
            out.update(self.control_bank.state_dict())
        return out

    def load_state_dict(self, state: dict) -> None:
        self.rounds_scheduled = int(np.asarray(
            state["rounds_scheduled"]))
        self.clients_sampled = int(np.asarray(state["clients_sampled"]))
        self.deadline_rounds = int(np.asarray(state["deadline_rounds"]))
        self.truncated_slots = int(np.asarray(state["truncated_slots"]))
        self.last_deadline_s = float(np.asarray(
            state["last_deadline_s"]))
        # files older than the high-water mark: the rounds counted
        self.rounds_committed = int(np.asarray(state.get(
            "rounds_committed", state["rounds_scheduled"])))
        if hasattr(self.policy, "load_state_dict"):
            self.policy.load_state_dict(state)
        if self.screen_ctl is not None:
            self.screen_ctl.load_state_dict(state)
        if self.control_bank is not None:
            self.control_bank.load_state_dict(state)


def attach_round_scheduler(model, train_loader) -> RoundScheduler:
    """The drivers' wiring: a RoundScheduler over the model's own
    tracker, attached to the train loader's sampler (selection) and the
    model (plans, and the sampler's stream in checkpoints). Call before
    --resume, so a checkpoint's sched_* state lands in it."""
    sched = RoundScheduler(model.cfg, model.num_clients,
                           model.throughput)
    train_loader.sampler.scheduler = sched
    model.attach_scheduler(sched)
    model.attach_data_sampler(train_loader.sampler)
    return sched
