"""The control plane's plan broadcast: the port of
commefficient_tpu/parallel/plantransport.py.

A scheduling policy that reads process-local state (the throughput
sampler's wall-clock rates, a deadline, the admission buffer) would
choose differently on each controller. With a transport attached, the
coordinator's RoundPlan of each round is the one decision:

  * the coordinator serializes it (`serialize_plan`: canonical JSON,
    byte for byte the JAX package's, so the two packages' journals and
    digests are interchangeable) and broadcasts it once a round;
  * every controller, the coordinator included, installs the DELIVERED
    bytes and cross-checks the plan's digest with the others
    (`PlanTransport.verify`, scope "plan");
  * FedModel digests what it then executes, the cohort after async
    admission with its survivor, work, poison and screen operands and
    the admission merges (`install_digest`), journals it write-ahead on
    the round's `schedule` event, flushed before the dispatch, and
    cross-checks it too (scope "install"); a divergence raises
    `PlanDigestError`;
  * a coordinator lost mid-run is survivable: any controller loads the
    shared checkpoint, is promoted, installs the journaled plans of the
    rounds past it (`journaled_plan_stream`) and checks its recomputed
    digests against the journaled ones.

Two transports:

  * `HostCollectiveTransport`, for ranks of a torch.distributed world
    (parallel/multihost.py): the plan packed into a fixed [8 +
    PLAN_MAX_BYTES] uint8 host buffer, one torch.distributed.broadcast
    from rank 0 a round, and the cross-check a gather of every rank's
    32-byte digest (an all_reduce of a zero [world, 32] buffer in which
    each rank writes its row) before any rank compares, so a divergence
    raises on every rank and none waits on another. The plan is host
    state, and NCCL moves only device buffers, so the transport runs on
    a gloo group of its own when the default group is NCCL's (every
    rank creates it, in the same order, where the transport is built).
    A collective that fails is not retried: a timeout one rank sees is
    not seen by the other, and a one-sided retry would deadlock. Out of
    torch.distributed it is the identity.
  * `EmulatedPlanNetwork` + `EmulatedTransport`: N controllers in one
    process over an in-memory bus, with utils/faults.FaultSchedule's
    control-plane faults scripted in (the coordinator dying
    mid-broadcast; lost, duplicated and slow broadcasts). Sends and
    receives ride utils/retry.with_retries, which rides out the scripted
    losses. `MirroredControllers` drives N RoundSchedulers over it in
    lockstep, as N processes would run the same sampler code.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from commefficient_tpu_torch.parallel import multihost as mh
from commefficient_tpu_torch.parallel.mesh import CollectiveStats
from commefficient_tpu_torch.utils.faults import FaultSchedule, InjectedFault
from commefficient_tpu_torch.utils.retry import with_retries

# the JAX package's constants, values unchanged
PLAN_WIRE_VERSION = 1

# the collective's fixed payload: an 8-byte length header and the
# serialized plan (a W = 4,096 cohort's plan is ~100 KB of JSON)
PLAN_MAX_BYTES = 1 << 20

DIGEST_BYTES = 32


class PlanDigestError(RuntimeError):
    """A controller's installed decision diverged from the broadcast
    plan stream, or from the journaled stream on a deterministic
    restart. Always fatal: the processes would dispatch different
    rounds."""


# -- serialization: RoundPlan <-> canonical JSON bytes -------------------


def _float_list(arr) -> Optional[List[float]]:
    if arr is None:
        return None
    # float() of an f32 survives JSON's shortest repr exactly, so
    # deserialize(serialize(p)) is bitwise p
    return [float(v) for v in np.asarray(arr, np.float32)]


def _opt_float(v) -> Optional[float]:
    return None if v is None else float(v)


def _dumps(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


def serialize_plan(plan) -> bytes:
    """A RoundPlan as canonical JSON (sorted keys, compact separators):
    deterministic, so its sha256 identifies the plan. `screen_mult` and
    `controls` are present only when set, so a plan without them has
    the bytes of a build that has neither."""
    obj = {
        "v": PLAN_WIRE_VERSION,
        "round": int(plan.round_idx),
        "n_sampled": int(plan.n_sampled),
        "sampler": str(plan.sampler),
        "participants": (None if plan.participants is None
                         else [int(c) for c in
                               np.asarray(plan.participants)]),
        "active": _float_list(plan.active),
        "work": _float_list(plan.work),
        "deadline_s": _opt_float(plan.deadline_s),
        "est_round_s": _opt_float(plan.est_round_s),
        "expected_round_s": _opt_float(plan.expected_round_s),
    }
    if plan.screen_mult is not None:
        obj["screen_mult"] = float(np.float32(plan.screen_mult))
    if plan.controls:
        # ints (span picks) exact, floats rounded to f32 as stamped
        obj["controls"] = {
            str(k): (int(v) if isinstance(v, (int, np.integer))
                     else float(np.float32(v)))
            for k, v in plan.controls.items()}
    return _dumps(obj)


def deserialize_plan(payload: bytes):
    """The inverse of serialize_plan; PlanDigestError on a wire version
    this build cannot install (a mixed-build fleet)."""
    from commefficient_tpu_torch.scheduler import RoundPlan
    obj = json.loads(payload.decode())
    if obj.get("v") != PLAN_WIRE_VERSION:
        raise PlanDigestError(
            f"plan wire version {obj.get('v')!r} != "
            f"{PLAN_WIRE_VERSION} — mixed-build controller fleet")

    def arr(key, dtype):
        v = obj.get(key)
        return None if v is None else np.asarray(v, dtype)

    return RoundPlan(
        int(obj["round"]), int(obj["n_sampled"]),
        arr("active", np.float32), arr("work", np.float32),
        obj.get("deadline_s"), obj.get("est_round_s"),
        obj.get("expected_round_s"), str(obj["sampler"]),
        arr("participants", np.int64),
        screen_mult=obj.get("screen_mult"),
        controls=obj.get("controls"))


def payload_digest(payload: bytes) -> str:
    return hashlib.sha256(payload).hexdigest()


def plan_digest(plan) -> str:
    return payload_digest(serialize_plan(plan))


def install_digest(round_idx: int, client_ids, survivors, work,
                   admits: Sequence = (), poison=None,
                   screen_on=None) -> str:
    """The digest of the decision a controller is about to execute: the
    cohort after admission, its survivor and work operands, and the
    admission merges (slot, client, weight, origin round). In the
    screened family the poison mask and the screen value are folded in
    too; left None, the bytes are those of a build without them."""
    obj = {
        "round": int(round_idx),
        "ids": [int(c) for c in np.asarray(client_ids).reshape(-1)],
        "surv": _float_list(survivors),
        "work": _float_list(work),
        "admits": [[int(s), int(c), float(np.float32(f)), int(o)]
                   for (s, c, f, o) in admits],
    }
    if poison is not None or screen_on is not None:
        obj["poison"] = _float_list(poison)
        obj["screen_on"] = (None if screen_on is None
                            else float(np.float32(screen_on)))
    return payload_digest(_dumps(obj))


def journaled_plan_stream(
        journal_path: str) -> Tuple[Dict[int, str], Dict[int, bytes]]:
    """A run journal's write-ahead stream in one read: ({round: digest},
    {round: serialized plan}) from its `schedule` events, a later
    record of a round replacing an earlier one (a resumed run journals
    its replayed rounds again). The plans are the authoritative log a
    restart installs (RoundScheduler.load_replay_plans); the digests
    check each replayed round's recomputed decision."""
    from commefficient_tpu_torch.telemetry.journal import read_journal
    digests: Dict[int, str] = {}
    plans: Dict[int, bytes] = {}
    if not os.path.exists(journal_path):
        return digests, plans
    records, _ = read_journal(journal_path)
    for rec in records:
        if (rec.get("event") != "schedule"
                or not isinstance(rec.get("round"), int)):
            continue
        if isinstance(rec.get("digest"), str):
            digests[rec["round"]] = rec["digest"]
        if isinstance(rec.get("plan"), str):
            plans[rec["round"]] = rec["plan"].encode()
    return digests, plans


def journaled_schedule_digests(journal_path: str) -> Dict[int, str]:
    """{round: digest} of the write-ahead stream."""
    return journaled_plan_stream(journal_path)[0]


def journaled_plans(journal_path: str) -> Dict[int, bytes]:
    """{round: plan bytes} of the write-ahead stream."""
    return journaled_plan_stream(journal_path)[1]


# -- the transports ------------------------------------------------------


class PlanTransport:
    """One-to-all broadcast of serialized plans and the cross-controller
    digest check. `broadcast(r, payload)` takes the payload on the
    coordinator and None elsewhere, and returns the DELIVERED payload to
    every caller (the coordinator installs the round trip too)."""

    @property
    def is_coordinator(self) -> bool:
        raise NotImplementedError

    def broadcast(self, round_idx: int,
                  payload: Optional[bytes] = None) -> bytes:
        raise NotImplementedError

    def verify(self, round_idx: int, digest: str,
               scope: str = "plan") -> None:
        """Cross-check this controller's digest with the others';
        PlanDigestError on a divergence. Scope "plan" is the installed
        plan's bytes, "install" the executed decision's digest; the two
        are checked apart."""
        raise NotImplementedError


class HostCollectiveTransport(PlanTransport):
    """The transport of a torch.distributed world (module docstring):
    a fixed-size broadcast from rank 0 and a digest gather, on a gloo
    group of its own under an NCCL default group. `stats` counts its
    collectives' calls, bytes and host seconds."""

    def __init__(self, max_bytes: int = PLAN_MAX_BYTES):
        self.max_bytes = int(max_bytes)
        self.stats = CollectiveStats()
        self.group = None
        if mh.is_distributed():
            import torch.distributed as dist
            if dist.get_backend() != "gloo":
                # a collective call: every rank builds the transport at
                # the same point of its run
                self.group = dist.new_group(backend="gloo")

    @property
    def is_coordinator(self) -> bool:
        return mh.is_coordinator()

    def pack(self, payload: Optional[bytes]) -> np.ndarray:
        """[8 + max_bytes] uint8: a little-endian length, then the
        payload; None (a follower's part) packs zeros."""
        buf = np.zeros(8 + self.max_bytes, np.uint8)
        if payload is not None:
            if len(payload) > self.max_bytes:
                raise ValueError(
                    f"serialized plan is {len(payload)} bytes > "
                    f"transport max {self.max_bytes}")
            buf[:8] = np.frombuffer(
                len(payload).to_bytes(8, "little"), np.uint8)
            buf[8:8 + len(payload)] = np.frombuffer(payload, np.uint8)
        return buf

    @staticmethod
    def unpack(buf) -> bytes:
        buf = np.asarray(buf, np.uint8)
        n = int.from_bytes(buf[:8].tobytes(), "little")
        return buf[8:8 + n].tobytes()

    def broadcast(self, round_idx: int,
                  payload: Optional[bytes] = None) -> bytes:
        buf = self.pack(payload)
        if not mh.is_distributed():
            return self.unpack(buf)
        import torch.distributed as dist
        t = torch.from_numpy(buf)
        t0 = time.perf_counter()
        dist.broadcast(t, src=0, group=self.group)
        self.stats.seconds += time.perf_counter() - t0
        self.stats.calls += 1
        self.stats.bytes += t.numel()
        return self.unpack(t.numpy())

    def verify(self, round_idx: int, digest: str,
               scope: str = "plan") -> None:
        if not mh.is_multihost():
            return
        import torch.distributed as dist
        mine = np.frombuffer(bytes.fromhex(digest), np.uint8)
        rows = torch.zeros((mh.process_count(), DIGEST_BYTES),
                           dtype=torch.int64)
        rows[mh.process_index()] = torch.from_numpy(mine.astype(np.int64))
        t0 = time.perf_counter()
        dist.all_reduce(rows, group=self.group)
        self.stats.seconds += time.perf_counter() - t0
        self.stats.calls += 1
        self.stats.bytes += rows.numel() * rows.element_size()
        all_d = rows.numpy()
        if not (all_d == mine[None, :]).all():
            bad = [p for p in range(all_d.shape[0])
                   if not (all_d[p] == mine).all()]
            raise PlanDigestError(
                f"round {round_idx}: {scope} digest diverged across "
                f"controllers (processes {bad} disagree with "
                f"process {mh.process_index()})")


class EmulatedPlanNetwork:
    """An in-memory broadcast bus for N controllers of one process, with
    the FaultSchedule's control-plane faults scripted in. `promote` is
    the deterministic takeover: the lowest surviving controller becomes
    the coordinator."""

    def __init__(self, num_controllers: int,
                 schedule: Optional[FaultSchedule] = None):
        if num_controllers < 1:
            raise ValueError("need at least one controller")
        self.num = int(num_controllers)
        self.schedule = schedule
        self.coordinator_id = 0
        self.dead: set = set()
        self._mail: Dict[int, bytes] = {}
        self._send_attempts: Dict[int, int] = {}
        self._recv_attempts: Dict[Tuple[int, int], int] = {}
        # round -> deliveries (2 under broadcast_dup)
        self.deliveries: Dict[int, int] = {}
        # (round, scope) -> {controller: digest}
        self._digests: Dict[Tuple[int, str], Dict[int, str]] = {}

    def promote(self, pid: Optional[int] = None) -> int:
        """Mark the coordinator dead and promote `pid` (default the
        lowest surviving controller); returns the new coordinator."""
        self.dead.add(self.coordinator_id)
        if pid is None:
            pid = min(p for p in range(self.num) if p not in self.dead)
        if pid in self.dead:
            raise ValueError(f"controller {pid} is dead")
        self.coordinator_id = int(pid)
        return self.coordinator_id

    def send(self, round_idx: int, payload: bytes) -> None:
        att = self._send_attempts.get(round_idx, 0)
        self._send_attempts[round_idx] = att + 1
        s = self.schedule
        if s is not None and s.broadcast_dropped(round_idx, att):
            raise TimeoutError(
                f"round {round_idx} plan broadcast lost in flight "
                "(scripted drop)")
        copies = 2 if (s is not None
                       and s.broadcast_duplicated(round_idx)) else 1
        self._mail[round_idx] = payload
        self.deliveries[round_idx] = (self.deliveries.get(round_idx, 0)
                                      + copies)

    def recv(self, round_idx: int, pid: int) -> bytes:
        key = (round_idx, pid)
        att = self._recv_attempts.get(key, 0)
        self._recv_attempts[key] = att + 1
        s = self.schedule
        if s is not None and att < s.broadcast_slow_attempts(round_idx):
            raise TimeoutError(
                f"round {round_idx} plan not yet visible to "
                f"controller {pid} (scripted slow broadcast)")
        payload = self._mail.get(round_idx)
        if payload is None:
            raise TimeoutError(f"round {round_idx} plan not yet broadcast")
        return payload

    def register_digest(self, round_idx: int, pid: int, digest: str,
                        scope: str = "plan") -> None:
        seen = self._digests.setdefault((round_idx, scope), {})
        for other, d in seen.items():
            if d != digest:
                raise PlanDigestError(
                    f"round {round_idx}: controller {pid} installed "
                    f"{scope} digest {digest[:12]}… but controller "
                    f"{other} installed {d[:12]}… — control plane "
                    "diverged")
        seen[pid] = digest


class EmulatedTransport(PlanTransport):
    """One controller's endpoint on an EmulatedPlanNetwork; sends and
    receives ride with_retries (no sleeping by default: the bus is in
    process)."""

    def __init__(self, network: EmulatedPlanNetwork, process_id: int,
                 retries: int = 8, retry_sleep=None):
        self.network = network
        self.pid = int(process_id)
        self.retries = int(retries)
        self._sleep = (retry_sleep if retry_sleep is not None
                       else (lambda s: None))

    @property
    def is_coordinator(self) -> bool:
        return self.pid == self.network.coordinator_id

    def broadcast(self, round_idx: int,
                  payload: Optional[bytes] = None) -> bytes:
        if self.pid in self.network.dead:
            raise RuntimeError(f"controller {self.pid} is dead")
        if self.is_coordinator and payload is not None:
            s = self.network.schedule
            if s is not None and s.should_crash_coordinator(round_idx):
                # the coordinator dies before the plan reaches the bus
                # (it may already be journaled)
                self.network.dead.add(self.pid)
                raise InjectedFault(round_idx - 1)
            with_retries(lambda: self.network.send(round_idx, payload),
                         retries=self.retries, base_delay=0.0,
                         sleep=self._sleep,
                         describe=f"round {round_idx} plan broadcast")
        return with_retries(lambda: self.network.recv(round_idx, self.pid),
                            retries=self.retries, base_delay=0.0,
                            sleep=self._sleep,
                            describe=f"round {round_idx} plan receive")

    def verify(self, round_idx: int, digest: str,
               scope: str = "plan") -> None:
        self.network.register_digest(round_idx, self.pid, digest, scope)


class MirroredControllers:
    """N RoundSchedulers in lockstep over one emulated network, standing
    for N processes running the same sampler code; it has the
    RoundScheduler surface the FedSampler and FedModel use.

    The coordinator selects and commits first (it owns the live tracker
    and broadcasts at commit_round). Each follower then runs the same
    select and commit on the same inputs, from its own replica of the
    sampler's rng (the stashed state) and the received plan: a real
    follower blocks in its receive until the broadcast lands, which
    here means after the coordinator's commit. A follower's selection
    must equal the coordinator's, and `take_plan` holds every
    controller's installed plan to the coordinator's, byte for byte."""

    def __init__(self, schedulers: List, transports: List,
                 coordinator: int = 0):
        if len(schedulers) != len(transports):
            raise ValueError("one transport per controller")
        self.schedulers = list(schedulers)
        self.transports = list(transports)
        self.coordinator = int(coordinator)
        self._pending_select = None
        self._pending_chosen = None

    @property
    def _coord(self):
        return self.schedulers[self.coordinator]

    @property
    def _followers(self):
        return [(pid, s) for pid, s in enumerate(self.schedulers)
                if pid != self.coordinator
                and pid not in self.transports[pid].network.dead]

    # -- the RoundScheduler surface ---------------------------------------
    @property
    def cfg(self):
        return self._coord.cfg

    @property
    def is_default(self) -> bool:
        return self._coord.is_default

    @property
    def tracker(self):
        return self._coord.tracker

    @property
    def state_prefetch(self):
        return self._coord.state_prefetch

    @state_prefetch.setter
    def state_prefetch(self, fn) -> None:
        self._coord.state_prefetch = fn

    @property
    def screen_ctl(self):
        return self._coord.screen_ctl

    @screen_ctl.setter
    def screen_ctl(self, ctl) -> None:
        # every controller holds it (a follower then plans every round
        # and installs the broadcast); only the model feeds it
        for s in self.schedulers:
            s.screen_ctl = ctl

    @property
    def control_bank(self):
        return self._coord.control_bank

    @control_bank.setter
    def control_bank(self, bank) -> None:
        # shared as screen_ctl is: the coordinator stamps plans through
        # it, only the model feeds it
        for s in self.schedulers:
            s.control_bank = bank

    def begin_epoch(self, first_round: int) -> None:
        self._pending_select = None
        for s in self.schedulers:
            s.begin_epoch(first_round)

    def select(self, alive, num_slots: int, rng) -> np.ndarray:
        # the coordinator's; the followers' runs at commit, each from a
        # replica of the rng as it stands now
        self._pending_select = (np.array(alive, copy=True),
                                int(num_slots), rng.get_state())
        out = self._coord.select(alive, num_slots, rng)
        self._pending_chosen = np.array(out, copy=True)
        return out

    def commit_round(self, client_ids, examples_per_slot) -> None:
        self._coord.commit_round(client_ids, examples_per_slot)
        pending = self._pending_select
        for pid, s in self._followers:
            if pending is not None:
                alive, num_slots, rng_state = pending
                frng = np.random.RandomState()
                frng.set_state(rng_state)
                theirs = np.asarray(s.select(alive, num_slots, frng))
                if not np.array_equal(self._pending_chosen, theirs):
                    raise PlanDigestError(
                        f"controller {pid} selected a different cohort "
                        f"than the coordinator at round {s._next_round}")
                fs = self.transports[pid].network.schedule
                if fs is not None and fs.broadcast_duplicated(
                        s._next_round):
                    # the second delivery lands between the follower's
                    # receive and its commit: installed idempotently
                    s._recv_plan(s._next_round)
            s.commit_round(client_ids, examples_per_slot)
        self._pending_select = None

    def take_plan(self, round_idx: int):
        plan = self._coord.take_plan(round_idx)
        ref = None if plan is None else serialize_plan(plan)
        for pid, s in self._followers:
            theirs = s.take_plan(round_idx)
            enc = None if theirs is None else serialize_plan(theirs)
            if enc != ref:
                raise PlanDigestError(
                    f"round {round_idx}: controller {pid} installed a "
                    "different plan than the coordinator")
        return plan

    def state_dict(self) -> dict:
        return self._coord.state_dict()

    def load_state_dict(self, state: dict) -> None:
        # shared storage: every controller restores the same state (how
        # a promoted follower inherits the coordinator's)
        for s in self.schedulers:
            s.load_state_dict(state)

    def load_replay_plans(self, plans: Dict[int, bytes]) -> None:
        # the coordinator installs and broadcasts them again; the
        # followers receive them as live rounds
        self._coord.load_replay_plans(plans)


def attach_emulated_cluster(model, train_loader, num_controllers: int = 2,
                            coordinator: int = 0,
                            schedule: Optional[FaultSchedule] = None,
                            network: Optional[EmulatedPlanNetwork] = None):
    """The emulated harness's wiring: N RoundSchedulers (the
    coordinator's over the model's live tracker, each follower's over a
    tracker of its own that is never fed, so a follower decision that
    leaked local state fails the cross-checks), their transports, the
    MirroredControllers as the run's scheduler, and the coordinator's
    transport on the model. Returns (mirror, network). Pass a `network`
    already promoted to model a takeover."""
    from commefficient_tpu_torch.scheduler import RoundScheduler
    from commefficient_tpu_torch.telemetry.clients import (
        ClientThroughputTracker,
    )
    if network is None:
        network = EmulatedPlanNetwork(num_controllers, schedule=schedule)
        network.coordinator_id = int(coordinator)
    coordinator = network.coordinator_id
    scheds, transports = [], []
    for pid in range(network.num):
        tracker = (model.throughput if pid == coordinator
                   else ClientThroughputTracker(model.num_clients))
        s = RoundScheduler(model.cfg, model.num_clients, tracker)
        t = EmulatedTransport(network, pid)
        s.attach_transport(t)
        scheds.append(s)
        transports.append(t)
    mirror = MirroredControllers(scheds, transports,
                                 coordinator=coordinator)
    train_loader.sampler.scheduler = mirror
    model.attach_scheduler(mirror)
    model.attach_data_sampler(train_loader.sampler)
    model.attach_transport(transports[coordinator])
    return mirror, network


def attach_config_transport(model, train_loader, cfg):
    """The drivers' wiring of Config.plan_transport, right after
    scheduler.attach_round_scheduler and before --resume:

      * "collective": a HostCollectiveTransport on the run's
        RoundScheduler and the model (every rank runs this line);
      * "emulated": the scheduler replaced by cfg.plan_controllers
        controllers in lockstep (MirroredControllers). Faults come from
        the environment: CCTPU_EMU_COORD_CRASH=<round> kills the
        coordinator mid-broadcast of that round, CCTPU_EMU_COORDINATOR=
        <pid> picks the coordinator (a takeover's).

    Returns the transport or the mirror, or None without a transport."""
    if not cfg.plan_transport:
        return None
    if cfg.plan_transport == "collective":
        t = HostCollectiveTransport()
        model.scheduler.attach_transport(t)
        model.attach_transport(t)
        return t
    schedule = None
    crash = os.environ.get("CCTPU_EMU_COORD_CRASH", "")
    if crash:
        schedule = FaultSchedule(coordinator_crash_at=int(crash))
    coordinator = int(os.environ.get("CCTPU_EMU_COORDINATOR", "0"))
    mirror, _ = attach_emulated_cluster(
        model, train_loader, num_controllers=int(cfg.plan_controllers),
        coordinator=coordinator, schedule=schedule)
    return mirror
