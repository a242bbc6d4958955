"""Per-client throughput tracking: the port's copy of the state half of
commefficient_tpu/telemetry/clients.py (EMA examples/sec and
participation counts of every client ever sampled).

The telemetry session feeds it one (client_ids, examples, seconds)
triple a round, from the interval between two dispatches. Storage is
sparse: only clients ever sampled own a row. `state_dict` and
`load_state_dict` round-trip the rows bit for bit; the checkpoint
carries them under `thr_*` keys. The rates are wall-clock EMAs, so two
runs of one seed differ in them; the round itself never reads them. The
reader half (`examples_per_sec`, `measured`, `estimate_round_seconds`)
feeds the round scheduler (commefficient_tpu_torch/scheduler): the
throughput-aware sampler and the deadline policy. `force` sets records
directly, for tests and drills that need rates off the wall clock.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# state_dict keys (the checkpoint serialization contract); legacy
# captures lack `ids` and carry dense [num_clients] arrays instead
STATE_KEYS = ("ids", "rate", "participations", "completions",
              "busy_seconds")


class ClientThroughputTracker:
    """rate[row] EMA examples/sec over completed rounds (0.0 until the
    first), participations[row] rounds sampled into, completions[row]
    rounds with examples processed, busy_seconds[row] their total
    wall seconds. `version` increments whenever an EMA changes."""

    def __init__(self, num_clients: int, ema_decay: float = 0.9):
        if not 0.0 < ema_decay < 1.0:
            raise ValueError(
                f"ema_decay={ema_decay} must be in (0, 1)")
        self.num_clients = int(num_clients)
        self.ema_decay = float(ema_decay)
        self._slot: dict = {}                      # global id -> row
        # capacity-backed arrays with a live-row count, doubled on
        # overflow
        self._n = 0
        self._ids = np.zeros((0,), np.int64)
        self._rate = np.zeros((0,), np.float32)
        self._participations = np.zeros((0,), np.int64)
        self._completions = np.zeros((0,), np.int64)
        self._busy = np.zeros((0,), np.float64)
        self.total_participations = 0
        self.total_completions = 0
        self.version = 0

    def _grow(self, need: int) -> None:
        cap = len(self._ids)
        if need <= cap:
            return
        new_cap = max(need, 2 * cap, 64)

        def grown(arr, dtype):
            out = np.zeros(new_cap, dtype)
            out[:self._n] = arr[:self._n]
            return out

        self._ids = grown(self._ids, np.int64)
        self._rate = grown(self._rate, np.float32)
        self._participations = grown(self._participations, np.int64)
        self._completions = grown(self._completions, np.int64)
        self._busy = grown(self._busy, np.float64)

    def _rows_for(self, ids: np.ndarray) -> np.ndarray:
        """Row indices for `ids`, allocating zero rows for first-seen
        clients (deduplicated); out-of-range ids raise."""
        fresh, fresh_seen = [], set()
        for c in ids:
            c = int(c)
            if not 0 <= c < self.num_clients:
                raise ValueError(
                    f"client id {c} out of range for a "
                    f"{self.num_clients}-client population")
            if c not in self._slot and c not in fresh_seen:
                fresh.append(c)
                fresh_seen.add(c)
        if fresh:
            self._grow(self._n + len(fresh))
            for c in fresh:
                self._slot[c] = self._n
                self._ids[self._n] = c
                self._n += 1
        return np.array([self._slot[int(c)] for c in ids], np.int64)

    @property
    def seen_ids(self) -> np.ndarray:
        """Global ids of every client that owns a row (a copy)."""
        return self._ids[:self._n].copy()

    def update_round(self, client_ids, num_examples, round_seconds,
                     survivors: Optional[np.ndarray] = None,
                     scheduled: Optional[np.ndarray] = None) -> None:
        """Fold one round in: client_ids [W] (distinct), num_examples
        [W] processed, round_seconds the round's wall seconds (<= 0 or
        None skips). survivors: optional [W] mask zeroing examples;
        scheduled: optional [W] mask whose zero slots are excluded."""
        if round_seconds is None or not round_seconds > 0:
            return
        ids = np.asarray(client_ids, np.int64).reshape(-1)
        ex = np.asarray(num_examples, np.float64).reshape(-1)
        if scheduled is not None:
            keep = np.asarray(scheduled).reshape(-1) > 0
            ids, ex = ids[keep], ex[keep]
        if survivors is not None:
            surv = np.asarray(survivors).reshape(-1)
            if scheduled is not None:
                surv = surv[keep]
            ex = ex * (surv > 0)
        rows = self._rows_for(ids)
        # unbuffered adds keep the rows consistent with the totals even
        # if a duplicate id slips through
        np.add.at(self._participations, rows, 1)
        self.total_participations += len(rows)
        done = ex > 0
        done_rows = rows[done]
        np.add.at(self._completions, done_rows, 1)
        self.total_completions += int(done.sum())
        np.add.at(self._busy, done_rows, float(round_seconds))
        if not done.any():
            return
        sample = (ex[done] / float(round_seconds)).astype(np.float32)
        prev = self._rate[done_rows]
        d = np.float32(self.ema_decay)
        # the first completion seeds the EMA with the sample itself
        first = self._completions[done_rows] <= 1
        self._rate[done_rows] = np.where(
            first, sample, d * prev + (np.float32(1.0) - d) * sample)
        self.version += 1

    # -- the reader half (the scheduler's inputs) --------------------------
    def examples_per_sec(self, client_ids=None) -> np.ndarray:
        """EMA rates of `client_ids` (0.0 for unmeasured or unseen
        clients); with None the dense [num_clients] vector."""
        if client_ids is None:
            out = np.zeros(self.num_clients, np.float32)
            out[self._ids[:self._n]] = self._rate[:self._n]
            return out
        return self._lookup(self._rate, client_ids,
                            np.float32(0.0)).astype(np.float32)

    def participation_counts(self, client_ids) -> np.ndarray:
        return self._lookup(self._participations, client_ids, 0)

    def completion_counts(self, client_ids) -> np.ndarray:
        return self._lookup(self._completions, client_ids, 0)

    def _lookup(self, arr, client_ids, default):
        ids = np.asarray(client_ids, np.int64).reshape(-1)
        return np.array([arr[self._slot[int(c)]]
                         if int(c) in self._slot else default
                         for c in ids], arr.dtype)

    def measured(self) -> Tuple[np.ndarray, np.ndarray]:
        """(ids, rates) of every client with a nonzero EMA: the alias
        sampler's table basis."""
        m = self._rate[:self._n] > 0
        return (self._ids[:self._n][m].copy(),
                self._rate[:self._n][m].copy())

    def estimate_round_seconds(self, client_ids, num_examples,
                               cold_start_seconds: Optional[float]
                               = None) -> np.ndarray:
        """Expected seconds for each client's batch at its EMA rate.
        Zero examples estimate 0.0; an unmeasured client +inf, or with
        `cold_start_seconds` its batch at the slowest measured rate
        (that value itself when nothing is measured). Never NaN."""
        ex = np.asarray(num_examples, np.float64)
        r = self.examples_per_sec(client_ids).astype(np.float64)
        with np.errstate(divide="ignore"):
            out = np.where(r > 0, ex / np.maximum(r, 1e-30), np.inf)
        out = np.where(ex <= 0, 0.0, out)
        unmeasured = (r <= 0) & (ex > 0)
        if unmeasured.any() and cold_start_seconds is not None:
            rows = self._rate[:self._n]
            live = rows[rows > 0]
            if live.size:
                out[unmeasured] = ex[unmeasured] / float(live.min())
            else:
                out[unmeasured] = float(cold_start_seconds)
        return out

    def force(self, client_ids, rate=None, participations=None,
              completions=None, busy_seconds=None) -> None:
        """Set per-client records directly (rows allocated as needed);
        a rate bumps `version` as a measurement does."""
        rows = self._rows_for(
            np.asarray(client_ids, np.int64).reshape(-1))
        if rate is not None:
            self._rate[rows] = np.asarray(rate, np.float32)
            self.version += 1
        if participations is not None:
            new = np.asarray(participations, np.int64)
            self.total_participations += int(
                new.sum() - self._participations[rows].sum())
            self._participations[rows] = new
        if completions is not None:
            new = np.asarray(completions, np.int64)
            self.total_completions += int(
                new.sum() - self._completions[rows].sum())
            self._completions[rows] = new
        if busy_seconds is not None:
            self._busy[rows] = np.asarray(busy_seconds, np.float64)

    def state_dict(self) -> dict:
        n = self._n
        return {
            "ids": self._ids[:n].copy(),
            "rate": self._rate[:n].copy(),
            "participations": self._participations[:n].copy(),
            "completions": self._completions[:n].copy(),
            "busy_seconds": self._busy[:n].copy(),
        }

    def load_state_dict(self, state: dict) -> None:
        rate = np.asarray(state["rate"], np.float32)
        if "ids" in state:
            ids = np.asarray(state["ids"], np.int64)
            if ids.size and ids.max() >= self.num_clients:
                raise ValueError(
                    f"throughput state tracks client id {ids.max()}; "
                    f"this run has {self.num_clients} clients")
        else:
            # legacy dense capture: keep only the rows that carry a
            # nonzero record (absent rows read as the dense zeros)
            if rate.shape[0] != self.num_clients:
                raise ValueError(
                    f"throughput state tracks {rate.shape[0]} clients; "
                    f"this run has {self.num_clients}")
            part = np.asarray(state["participations"], np.int64)
            comp = np.asarray(state["completions"], np.int64)
            busy = np.asarray(state["busy_seconds"], np.float64)
            seen = (rate > 0) | (part > 0) | (comp > 0) | (busy > 0)
            ids = np.where(seen)[0].astype(np.int64)
            state = {"rate": rate[seen], "participations": part[seen],
                     "completions": comp[seen], "busy_seconds": busy[seen]}
            rate = state["rate"]
        self._n = len(ids)
        self._ids = ids.copy()
        self._slot = {int(c): i for i, c in enumerate(ids)}
        self._rate = rate.copy()
        self._participations = np.asarray(
            state["participations"], np.int64).copy()
        self._completions = np.asarray(
            state["completions"], np.int64).copy()
        self._busy = np.asarray(
            state["busy_seconds"], np.float64).copy()
        self.total_participations = int(self._participations.sum())
        self.total_completions = int(self._completions.sum())
        self.version += 1
