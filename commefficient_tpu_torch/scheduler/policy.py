"""Participant-sampling policies, the port of
commefficient_tpu/scheduler/policy.py: who joins each round.

`UniformSampler` is the reference's draw, `rng.choice(alive, n,
replace=False)` on the FedSampler's own RandomState, so the default
stream is the scheduler-free one bit for bit. `ThroughputAwareSampler`
weighs each alive client by its EMA rate (telemetry/clients.py) raised
to `speed_bias`, mixed with an exploration floor, and draws from its
own generator, SeedSequence([seed, DOMAINS["sampler"], round]): the
fault draws never see it, and the same tracker state chooses the same
ids as the JAX package's, bit for bit (the numpy calls are its calls,
in its order).
"""
from __future__ import annotations

import numpy as np

from commefficient_tpu_torch.telemetry.clients import ClientThroughputTracker
from commefficient_tpu_torch.utils.faults import DOMAINS

SCHED_DOMAIN = DOMAINS["sampler"]

SAMPLERS = ("uniform", "throughput")


class ParticipantSampler:
    """Pick `num_slots` distinct ids of `alive` for round `round_idx`;
    `rng` is the FedSampler's RandomState, which only the uniform
    policy draws from."""

    name = "?"
    # whether the choice reads this process's own state (a tracker fed
    # its wall clock): a follower controller then installs the
    # coordinator's broadcast choice instead of drawing
    process_local = False

    def select(self, alive: np.ndarray, num_slots: int, rng,
               round_idx: int) -> np.ndarray:
        raise NotImplementedError


class UniformSampler(ParticipantSampler):
    """The reference's uniform draw, the pre-scheduler call verbatim."""

    name = "uniform"

    def select(self, alive, num_slots, rng, round_idx):
        return rng.choice(alive, num_slots, replace=False)


class AliasTable:
    """Walker/Vose alias table over fixed unnormalized weights: O(n)
    build (a deterministic partition, so a table rebuilt from a
    checkpointed snapshot is the same table), O(1) a draw."""

    def __init__(self, ids: np.ndarray, weights: np.ndarray):
        ids = np.asarray(ids, np.int64)
        w = np.asarray(weights, np.float64)
        assert len(ids) == len(w) and (w > 0).all()
        n = len(ids)
        self.ids = ids
        self.n = n
        p = w * (n / w.sum())
        prob = np.ones(n)
        alias = np.arange(n)
        small = [i for i in range(n) if p[i] < 1.0]
        large = [i for i in range(n) if p[i] >= 1.0]
        while small and large:
            s, l = small.pop(), large.pop()
            prob[s] = p[s]
            alias[s] = l
            p[l] = (p[l] + p[s]) - 1.0
            (small if p[l] < 1.0 else large).append(l)
        self.prob = prob
        self.alias = alias

    def draw(self, gen) -> int:
        """One draw -> a client id (two uniforms, in a fixed order)."""
        col = int(gen.integers(self.n))
        if gen.random() < self.prob[col]:
            return int(self.ids[col])
        return int(self.ids[self.alias[col]])


class ThroughputAwareSampler(ParticipantSampler):
    """A draw favouring fast clients, with an exploration floor:

        p = (1 - explore_floor) * rate**speed_bias / sum(...)
            + explore_floor / len(alive)

    Unmeasured clients take the median measured rate (a neutral prior);
    with nothing measured the draw is uniform. The biased part is an
    alias table over the tracker's measured clients, rebuilt when a
    rate moved by more than `rebuild_tol` or a client was first
    measured; each slot picks a mixture component once and rejects
    inside it, and duplicates restart the slot. A rejection streak past
    the budget falls back to the exact `gen.choice` on a sub-seeded
    generator. The snapshot the table was built from rides in
    checkpoints (`state_dict`), so a resumed run rebuilds the same
    table and draws the same stream."""

    name = "throughput"
    process_local = True    # reads the coordinator's live tracker

    def __init__(self, seed: int, tracker: ClientThroughputTracker,
                 explore_floor: float = 0.1, speed_bias: float = 2.0,
                 rebuild_tol: float = 0.05):
        if not 0.0 <= explore_floor <= 1.0:
            raise ValueError(
                f"explore_floor={explore_floor} must be in [0, 1] "
                "(1.0 degenerates to uniform)")
        if speed_bias <= 0:
            raise ValueError(
                f"speed_bias={speed_bias} must be > 0 (1.0 = "
                "throughput-proportional)")
        self.seed = int(seed)
        self.tracker = tracker
        self.explore_floor = float(explore_floor)
        self.speed_bias = float(speed_bias)
        self.rebuild_tol = float(rebuild_tol)
        self._table = None
        self._snap_ids = np.zeros((0,), np.int64)
        self._snap_rates = np.zeros((0,), np.float64)
        self._snap_version = -1
        self.rebuilds = 0

    def weights(self, alive: np.ndarray) -> np.ndarray:
        """The normalized selection probabilities over `alive`: the
        distribution the alias draw realizes, and the exact fallback's
        `p`."""
        alive = np.asarray(alive, np.int64)
        rates = self.tracker.examples_per_sec(alive).astype(np.float64)
        measured = rates > 0
        if measured.any():
            rates = np.where(measured, rates,
                             float(np.median(rates[measured])))
            # normalized by the max first, so the power never overflows
            w = (rates / rates.max()) ** self.speed_bias
            p = w / w.sum()
        else:
            p = np.full(len(alive), 1.0 / len(alive))
        f = self.explore_floor
        p = (1.0 - f) * p + f / len(alive)
        return p / p.sum()

    def _maybe_rebuild(self) -> None:
        if self.tracker.version == self._snap_version:
            return
        ids, rates = self.tracker.measured()
        rates = rates.astype(np.float64)
        self._snap_version = self.tracker.version
        if len(ids) == len(self._snap_ids) and \
                np.array_equal(ids, self._snap_ids):
            prev = self._snap_rates
            denom = np.maximum(np.abs(prev), 1e-30)
            if len(ids) == 0 or \
                    float(np.max(np.abs(rates - prev) / denom)) \
                    <= self.rebuild_tol:
                return
        self._rebuild(ids, rates)

    def _rebuild(self, ids: np.ndarray, rates: np.ndarray) -> None:
        self._snap_ids = np.asarray(ids, np.int64)
        self._snap_rates = np.asarray(rates, np.float64)
        if len(ids):
            rmax = float(self._snap_rates.max())
            w = (self._snap_rates / rmax) ** self.speed_bias
            self._table = AliasTable(self._snap_ids, w)
        else:
            self._table = None
        self.rebuilds += 1

    def select(self, alive, num_slots, rng, round_idx):
        # sorted: the membership test below searches `alive`
        alive = np.sort(np.asarray(alive, np.int64))
        num_slots = int(num_slots)
        gen = np.random.default_rng(np.random.SeedSequence(
            [self.seed, SCHED_DOMAIN, int(round_idx)]))
        self._maybe_rebuild()
        table = self._table
        if table is None:
            return self._draw_uniform(gen, alive, num_slots, round_idx)
        pos = np.searchsorted(alive, table.ids)
        pos = np.minimum(pos, len(alive) - 1)
        m_alive = alive[pos] == table.ids
        n_measured_alive = int(m_alive.sum())
        n_unmeasured_alive = len(alive) - n_measured_alive
        if n_measured_alive == 0:
            return self._draw_uniform(gen, alive, num_slots, round_idx)
        r_alive = self._snap_rates[m_alive]
        rmax = float(r_alive.max())
        mass_measured = float(((r_alive / rmax)
                               ** self.speed_bias).sum())
        med = float(np.median(r_alive))
        w_unmeasured = (med / rmax) ** self.speed_bias
        mass_unmeasured = n_unmeasured_alive * w_unmeasured
        p_unmeasured = mass_unmeasured / (mass_measured
                                          + mass_unmeasured)
        measured_set = set(int(c) for c in table.ids[m_alive])

        chosen: list = []
        chosen_set: set = set()
        f = self.explore_floor
        # one rejection budget for the whole round
        budget = [64 * num_slots + 256]

        def spend() -> bool:
            budget[0] -= 1
            return budget[0] > 0

        while len(chosen) < num_slots and spend():
            if f > 0 and gen.random() < f:
                cand = int(alive[int(gen.integers(len(alive)))])
            elif gen.random() < p_unmeasured:
                # uniform over the unmeasured alive
                cand = None
                while spend():
                    c = int(alive[int(gen.integers(len(alive)))])
                    if c not in measured_set:
                        cand = c
                        break
                if cand is None:
                    break
            else:
                # the table restricted to the alive ones
                cand = None
                while spend():
                    c = table.draw(gen)
                    if c in measured_set:
                        cand = c
                        break
                if cand is None:
                    break
            if cand in chosen_set:
                continue
            chosen.append(cand)
            chosen_set.add(cand)
        if len(chosen) < num_slots:
            gen_fb = np.random.default_rng(np.random.SeedSequence(
                [self.seed, SCHED_DOMAIN, int(round_idx), 1]))
            return gen_fb.choice(alive, size=num_slots, replace=False,
                                 p=self.weights(alive))
        return np.asarray(chosen, np.int64)

    def _draw_uniform(self, gen, alive, num_slots, round_idx):
        chosen: list = []
        seen: set = set()
        budget = 64 * num_slots + 256
        while len(chosen) < num_slots and budget > 0:
            budget -= 1
            cand = int(alive[int(gen.integers(len(alive)))])
            if cand in seen:
                continue
            chosen.append(cand)
            seen.add(cand)
        if len(chosen) < num_slots:
            gen_fb = np.random.default_rng(np.random.SeedSequence(
                [self.seed, SCHED_DOMAIN, int(round_idx), 1]))
            return gen_fb.choice(alive, size=num_slots, replace=False)
        return np.asarray(chosen, np.int64)

    # -- the sched_* checkpoint keys (the JAX package's) -----------------
    def state_dict(self) -> dict:
        return {
            "alias_rebuilds": np.int64(self.rebuilds),
            "alias_ids": self._snap_ids.copy(),
            "alias_rates": self._snap_rates.copy(),
        }

    def load_state_dict(self, state: dict) -> None:
        if "alias_rebuilds" not in state:
            return
        ids = np.asarray(state.get("alias_ids", ()), np.int64)
        rates = np.asarray(state.get("alias_rates", ()), np.float64)
        if len(ids):
            self._rebuild(ids, rates)
        self.rebuilds = int(np.asarray(state["alias_rebuilds"]))
        # the first select after a resume runs the rebuild check, which
        # is idempotent in (rates, snapshot): the same table either way
        self._snap_version = -1


def make_sampler(cfg, tracker: ClientThroughputTracker
                 ) -> ParticipantSampler:
    """The policy of `Config.sampler`."""
    if cfg.sampler == "uniform":
        return UniformSampler()
    if cfg.sampler == "throughput":
        return ThroughputAwareSampler(cfg.seed, tracker,
                                      explore_floor=cfg.explore_floor)
    raise ValueError(f"unknown sampler {cfg.sampler!r}")
