"""Staleness decay: the port of commefficient_tpu/control/staleness.py.

The async admission buffer (federated/async_agg.py) discounts a
deferred slot's late work by `decay ** rounds_late`. This controller
moves the decay after every committed round from the round's
`estimate_residual` metric, error_l2 / (error_l2 + update_l2), the share
of the round's information the sketch left behind: above
--staleness_target the decay tightens (late work is discounted harder),
below it loosens, by (1 + step), clamped to [staleness_decay_min,
staleness_decay_max]. The plan carries the decay, and the model sets the
buffer's decay from the PLAN's value before it composes the round.

The signal is computed by the round, but which rounds have committed
when round r is drawn depends on how far staging runs ahead (spans, the
pipeline). So the stamp is fixed-lag: every commit appends (round,
decay) to a ring, and round r's plan takes the ring's entry at r - lag,
where the lag is the most staging can run ahead: 1 for the per-round
loop, the largest span under --scan_rounds, twice that under
--pipeline. The stamped trajectory is then a function of the per-round
signals alone, whatever the span cuts and wherever a resume lands.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from commefficient_tpu_torch.control.base import Adjustment, Controller

__all__ = ["StalenessDecayController"]


def _observe_lag(cfg) -> int:
    """Rounds between a commit and the first stamped plan that may see
    it: the most staging runs ahead of commits."""
    pal = tuple(getattr(cfg, "span_palette", ()) or ())
    if pal:
        horizon = max(pal)
    elif getattr(cfg, "scan_rounds", False):
        horizon = max(int(getattr(cfg, "scan_span", 0)), 1)
    else:
        horizon = 1
    return 2 * horizon if getattr(cfg, "pipeline", False) else horizon


class StalenessDecayController(Controller):
    """Tune the async admission's staleness decay from the
    estimate_residual metric."""

    NAME = "staleness_decay"
    WIRE_FIELD = "staleness_decay"
    STATE_KEYS = ("decay", "rounds_observed", "ring")
    # the metric observed at commit (telemetry/metrics.py)
    SIGNAL = "estimate_residual"
    COMMIT_STATE = True

    def __init__(self, cfg):
        self.target = float(cfg.staleness_target)
        self.step = float(cfg.staleness_step)
        self.lo = float(cfg.staleness_decay_min)
        self.hi = float(cfg.staleness_decay_max)
        self.lag = _observe_lag(cfg)
        # the decay after the newest observed commit
        self.decay = self._f32(
            min(max(float(cfg.async_staleness_decay), self.lo), self.hi))
        self.init_decay = self.decay
        self.rounds_observed = 0
        # [n, 2] (round, decay after its commit), in round order
        self.ring = np.zeros((0, 2), np.float64)
        # the value the last stamped or installed plan carried
        self.stamped = self.decay

    def plan_value(self) -> float:
        return self._f32(self.stamped)

    def install(self, value) -> None:
        # the plan's value is what the round applies; the fold itself
        # moves only in observe_commit
        self.stamped = float(value)

    def _lagged(self, round_idx: int) -> float:
        """The decay after the newest commit at or before
        round_idx - lag (the initial decay before any)."""
        k = int(round_idx) - self.lag
        ring = np.asarray(self.ring, np.float64).reshape(-1, 2)
        eligible = ring[ring[:, 0] <= k]
        if len(eligible) == 0:
            return self._f32(self.init_decay)
        return self._f32(eligible[-1, 1])

    def stamp(self, round_idx, ids, ex, tracker):
        del ids, ex, tracker
        self.stamped = self._lagged(round_idx)
        return self.plan_value(), None, None

    def observe_commit(self, round_idx: int,
                       signals: dict) -> Optional[Adjustment]:
        resid = signals.get(self.SIGNAL)
        if resid is None:
            return None
        self.rounds_observed += 1
        resid = float(resid)
        old = self._f32(self.decay)
        new, clamped = old, False
        if resid > self.target:
            raw = old / (1.0 + self.step)
            new, clamped = max(raw, self.lo), raw < self.lo
        elif resid < self.target:
            raw = old * (1.0 + self.step)
            new, clamped = min(raw, self.hi), raw > self.hi
        new = self._f32(new)
        self.decay = new
        # every observed commit gets an entry, moved or not, so the
        # lagged lookup lands on exact rounds
        ring = np.asarray(self.ring, np.float64).reshape(-1, 2)
        ring = np.concatenate([ring, [[float(int(round_idx)), new]]],
                              axis=0)
        self.ring = ring[-(4 * self.lag + 4):]
        if new != old:
            return Adjustment(self.NAME, int(round_idx), resid, old, new,
                              bool(clamped))
        return None
