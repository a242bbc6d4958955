"""Deterministic fault injection for federated rounds: the port of
commefficient_tpu/utils/faults.py.

The failure classes the round engine models:

  * client dropout — a sampled client does not complete the round: its
    upload is excluded from the aggregate, its per-client rows come
    back untouched, and the accountant charges it nothing;
  * stragglers — a sampled client finishes only a fraction of its
    local work (its first examples, or its first local SGD steps under
    fedavg); a fraction below Config.straggler_cutoff degrades to the
    dropout path;
  * value faults (`poison`) — a client's transmitted update is
    corrupted (NaN, Inf or scaled by round.POISON_SCALE);
  * adversaries (`byzantine`) — a client submits the crafted update of
    Config.attack;
  * run preemption — the process dies after a round (`crash_after`) or
    while one is in flight (`crash_in_span`).

`bernoulli_survivors`, `straggler_work_fractions`, `poison_mask` and
`byzantine_mask` are the random draws of the production flags, pure
functions of (seed, round) on numpy's counter-based generator, each on
its own domain tag (DOMAINS, the JAX package's integers unchanged), so a
resumed or rolled-back run replays the identical faults, bit for bit
the JAX package's. `FaultSchedule` scripts them for tests and drills,
and scripts the control plane's faults too (the coordinator dying
mid-broadcast, lost, duplicated and late broadcasts), which the plan
transport consumes (parallel/plantransport.py), never FedModel.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence

import numpy as np

# the PRNG domain tags (the JAX package's values, frozen: changing one
# changes every historical run's fault replay) live in the registry;
# scheduler/policy and compress/ import them from here
from commefficient_tpu_torch.analysis.domains import DOMAINS


class InjectedFault(RuntimeError):
    """Raised by FedModel when a FaultSchedule says the run crashes
    after a given round; `round_idx` is the last completed round."""

    def __init__(self, round_idx: int):
        super().__init__(f"injected fault: crash after round {round_idx}")
        self.round_idx = int(round_idx)


def _rng(seed: int, domain: str, round_idx: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed), DOMAINS[domain], int(round_idx)]))


def bernoulli_survivors(seed: int, round_idx: int, num_workers: int,
                        dropout: float) -> np.ndarray:
    """[num_workers] f32 {0,1} survivor mask, Bernoulli(1 - dropout)
    per participant slot."""
    if dropout <= 0.0:
        return np.ones(num_workers, np.float32)
    rng = _rng(seed, "dropout", round_idx)
    return (rng.random(num_workers) >= dropout).astype(np.float32)


def straggler_work_fractions(seed: int, round_idx: int, num_workers: int,
                             rate: float,
                             min_work: float = 0.1) -> np.ndarray:
    """[num_workers] f32 work fractions in (0, 1]: each slot is a
    straggler with probability `rate`, working a fraction uniform in
    [min_work, 1); everyone else works 1.0."""
    if rate <= 0.0:
        return np.ones(num_workers, np.float32)
    rng = _rng(seed, "straggler", round_idx)
    is_straggler = rng.random(num_workers) < rate
    frac = min_work + (1.0 - min_work) * rng.random(num_workers)
    return np.where(is_straggler, frac, 1.0).astype(np.float32)


def poison_mask(seed: int, round_idx: int, num_workers: int,
                rate: float) -> np.ndarray:
    """[num_workers] f32 {0,1}: 1 marks a slot whose transmitted update
    is corrupted this round (Config.poison_kind says how)."""
    if rate <= 0.0:
        return np.zeros(num_workers, np.float32)
    rng = _rng(seed, "poison", round_idx)
    return (rng.random(num_workers) < rate).astype(np.float32)


def byzantine_mask(seed: int, round_idx: int, num_workers: int,
                   rate: float) -> np.ndarray:
    """[num_workers] f32 {0,1}: 1 marks a slot the adversary controls
    this round (Config.attack says what it submits)."""
    if rate <= 0.0:
        return np.zeros(num_workers, np.float32)
    rng = _rng(seed, "byzantine", round_idx)
    return (rng.random(num_workers) < rate).astype(np.float32)


def _slot_mask(spec, round_idx: int, num_slots: int) -> Optional[np.ndarray]:
    slots = spec.get(int(round_idx))
    if slots is None:
        return None
    out = np.zeros(num_slots, np.float32)
    out[np.asarray(slots, np.int64)] = 1.0
    return out


@dataclass(frozen=True)
class FaultSchedule:
    """A deterministic script of failures for one run.

    drop:        {round: GLOBAL client ids that drop that round}
    drop_slots:  {round: participant SLOTS that drop}
    drop_all:    rounds in which every sampled client drops
    slow:        {round: {slot: work fraction in (0, 1]}}, composed with
                 the random straggler draw by elementwise minimum
    poison:      {round: slots whose update is corrupted}, composed with
                 the random poison draw by elementwise maximum
    byzantine:   {round: slots the adversary controls}, likewise
    crash_after: raise InjectedFault once this round has completed
    crash_in_span: raise InjectedFault(round - 1) before this round
                 commits anything (each round is its own span here); it
                 fires again on a resume that keeps the schedule

    Control-plane faults, consumed by the plan transport
    (parallel/plantransport.py), not by FedModel:

    coordinator_crash_at: the coordinator dies while broadcasting this
                 round's plan, before it reaches any other controller
                 (it may already be journaled write-ahead). Raises
                 InjectedFault(round - 1), the last round completed; it
                 fires again while the schedule stays installed.
    broadcast_drop: rounds whose first broadcast send is lost (the
                 retry around the send delivers it).
    broadcast_dup: rounds delivered twice; the install is idempotent by
                 round.
    broadcast_slow: {round: n}: the first n receives of that round time
                 out before the payload lands.
    """
    drop: Mapping[int, Sequence[int]] = field(default_factory=dict)
    drop_slots: Mapping[int, Sequence[int]] = field(default_factory=dict)
    drop_all: Sequence[int] = ()
    slow: Mapping[int, Mapping[int, float]] = field(default_factory=dict)
    poison: Mapping[int, Sequence[int]] = field(default_factory=dict)
    byzantine: Mapping[int, Sequence[int]] = field(default_factory=dict)
    crash_after: Optional[int] = None
    crash_in_span: Optional[int] = None
    coordinator_crash_at: Optional[int] = None
    broadcast_drop: Sequence[int] = ()
    broadcast_dup: Sequence[int] = ()
    broadcast_slow: Mapping[int, int] = field(default_factory=dict)

    def survival_mask(self, round_idx: int,
                      client_ids) -> Optional[np.ndarray]:
        """[W] f32 survivor mask for this round, or None when the
        schedule says nothing about it."""
        round_idx = int(round_idx)
        client_ids = np.asarray(client_ids)
        if round_idx in set(int(r) for r in self.drop_all):
            return np.zeros(client_ids.shape[0], np.float32)
        mask = None
        dropped = self.drop.get(round_idx)
        if dropped is not None:
            mask = (~np.isin(client_ids,
                             np.asarray(dropped))).astype(np.float32)
        slots = self.drop_slots.get(round_idx)
        if slots is not None:
            if mask is None:
                mask = np.ones(client_ids.shape[0], np.float32)
            mask[np.asarray(slots, np.int64)] = 0.0
        return mask

    def work_fractions(self, round_idx: int,
                       num_slots: int) -> Optional[np.ndarray]:
        """[W] f32 scripted work fractions, or None when no straggler is
        scripted for this round. Zero work is a dropped client, not a
        straggler: script it with drop/drop_slots."""
        spec = self.slow.get(int(round_idx))
        if spec is None:
            return None
        out = np.ones(num_slots, np.float32)
        for slot, frac in spec.items():
            frac = float(frac)
            if not 0.0 < frac <= 1.0:
                raise ValueError(
                    f"FaultSchedule.slow[{round_idx}][{slot}] = {frac} "
                    "is outside the (0, 1] work-fraction domain; for "
                    "zero work use drop/drop_slots (dropout), or a "
                    "small fraction below Config.straggler_cutoff")
            out[int(slot)] = frac
        return out

    def poison_mask_for(self, round_idx: int,
                        num_slots: int) -> Optional[np.ndarray]:
        return _slot_mask(self.poison, round_idx, num_slots)

    def byzantine_mask_for(self, round_idx: int,
                           num_slots: int) -> Optional[np.ndarray]:
        return _slot_mask(self.byzantine, round_idx, num_slots)

    def should_crash(self, round_idx: int) -> bool:
        return (self.crash_after is not None
                and int(round_idx) == int(self.crash_after))

    def should_crash_in_span(self, first_round: int, n_rounds: int) -> bool:
        return (self.crash_in_span is not None
                and int(first_round) <= int(self.crash_in_span)
                < int(first_round) + int(n_rounds))

    def should_crash_coordinator(self, round_idx: int) -> bool:
        """Whether the coordinator dies broadcasting this round's plan
        (the transport raises InjectedFault(round_idx - 1))."""
        return (self.coordinator_crash_at is not None
                and int(round_idx) == int(self.coordinator_crash_at))

    def broadcast_dropped(self, round_idx: int, attempt: int) -> bool:
        """Whether this send attempt of the round's broadcast is lost
        (only the first; the retry goes through)."""
        return (attempt == 0 and int(round_idx)
                in set(int(r) for r in self.broadcast_drop))

    def broadcast_duplicated(self, round_idx: int) -> bool:
        return int(round_idx) in set(int(r) for r in self.broadcast_dup)

    def broadcast_slow_attempts(self, round_idx: int) -> int:
        """How many receives of this round time out before the payload
        is visible (0: delivered at once)."""
        return int(self.broadcast_slow.get(int(round_idx), 0))
