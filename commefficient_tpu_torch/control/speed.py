"""Cohort speed matching: the port of commefficient_tpu/control/speed.py.

At plan-stamp time the controller compares each measured active
client's examples/s EMA (telemetry/clients.ClientThroughputTracker)
with the cohort median. A client slower than `ratio` x median gets a
work fraction below 1 (its rate over the median, at least
_MIN_DEFER_FRAC), min-composed onto plan.work as a deadline's is; the
async admission buffer (federated/async_agg.py) then defers that slot
and admits its work --async_admit_rounds later at the staleness
discount, so a slow client no longer holds its cohort back.

The ratio is the controller's knob: the share of the active cohort it
would flag is steered toward --speed_match_target by (1 + step) a
round, clamped to [speed_ratio_min, speed_ratio_max] (max < 1, so at
most half the measured cohort is ever below ratio x median).

The rates are wall-clock, so the decision is taken only on a fresh
round's stamp; the plan carries the ratio, and a replayed round installs
it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from commefficient_tpu_torch.control.base import Adjustment, Controller

__all__ = ["SpeedMatchController"]

# the least work fraction a deferred slot carries
_MIN_DEFER_FRAC = 0.25


class SpeedMatchController(Controller):
    """Defer measured-slow clients into async admission slots."""

    NAME = "speed_match"
    WIRE_FIELD = "speed_ratio"
    STATE_KEYS = ("ratio", "rounds_observed")

    def __init__(self, cfg):
        self.target = float(cfg.speed_match_target)
        self.step = float(cfg.speed_match_step)
        self.lo = float(cfg.speed_ratio_min)
        self.hi = float(cfg.speed_ratio_max)
        self.ratio = self._f32(
            min(max(float(cfg.speed_ratio), self.lo), self.hi))
        self.rounds_observed = 0

    def plan_value(self) -> float:
        return self._f32(self.ratio)

    def install(self, value) -> None:
        self.ratio = float(value)

    def stamp(self, round_idx: int, ids: np.ndarray, ex: np.ndarray,
              tracker) -> Tuple[float, Optional[np.ndarray],
                                Optional[Adjustment]]:
        ex = np.asarray(ex, np.float64).reshape(-1)
        ids = np.asarray(ids).reshape(-1)
        active = ex > 0
        rates = np.asarray(tracker.examples_per_sec(ids),
                           np.float64).reshape(-1)
        # a rate of 0 is "never measured": no evidence, never slow; a
        # median needs two measured rates
        measured = active & (rates > 0.0)
        work = None
        adj = None
        if int(measured.sum()) >= 2:
            med = float(np.median(rates[measured]))
            if med > 0.0:
                # the signal is the share the current ratio would flag;
                # the slots are flagged under the adjusted ratio, so the
                # stamped value and the stamped work agree
                slow = measured & (rates < self.plan_value() * med)
                signal = (float(slow.sum())
                          / float(max(int(active.sum()), 1)))
                adj = self._observe(round_idx, signal)
                slow = measured & (rates < self.plan_value() * med)
                if bool(slow.any()):
                    work = np.ones(len(ex), np.float32)
                    frac = np.maximum(rates[slow] / med, _MIN_DEFER_FRAC)
                    work[slow] = frac.astype(np.float32)
        return self.plan_value(), work, adj

    def _observe(self, round_idx: int,
                 signal: float) -> Optional[Adjustment]:
        self.rounds_observed += 1
        old = self.plan_value()
        if signal > self.target:
            # flagging too much of the cohort: lower the bar
            raw = old / (1.0 + self.step)
            new, clamped = max(raw, self.lo), raw < self.lo
        elif signal < self.target:
            raw = old * (1.0 + self.step)
            new, clamped = min(raw, self.hi), raw > self.hi
        else:
            return None
        new = self._f32(new)
        self.ratio = new
        if new != old:
            return Adjustment(self.NAME, int(round_idx), float(signal),
                              old, new, bool(clamped))
        return None
