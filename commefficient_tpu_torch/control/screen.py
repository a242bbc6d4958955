"""The adaptive norm screen: the port of
commefficient_tpu/control/screen.py.

`--update_screen norm` refuses a client update whose l2 norm exceeds a
multiplier times the cohort median. With `--target_screened_rate` the
multiplier is not fixed: after every committed round the controller
compares the screened share of the cohort with the target and moves the
multiplier by (1 + step) toward it (rate above target: loosen; below:
tighten), clamped to [screen_mult_min, screen_mult_max], in float32.

The multiplier each round runs with rides its plan
(`RoundPlan.screen_mult`) and reaches the round as the VALUE of the
screen operand (federated/round.admission); screen_mult_min > 1 keeps it
apart from the screen-off value 0. The trajectory is pure arithmetic on
the journaled counts, so a resumed run continues it from the checkpoint
(`sched_screen_mult`, `sched_screen_rounds_observed`: the JAX package's
unprefixed keys). The scheduler package re-exports the class.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from commefficient_tpu_torch.control.base import Controller

__all__ = ["AdaptiveScreenController"]


class AdaptiveScreenController(Controller):
    """Steers the norm screen's multiplier toward
    --target_screened_rate."""

    NAME = "screen_adapt"
    WIRE_FIELD = "screen_mult"
    STATE_KEYS = ("screen_mult", "screen_rounds_observed")

    def __init__(self, cfg):
        self.target = float(cfg.target_screened_rate)
        self.step = float(cfg.screen_adapt_step)
        self.lo = float(cfg.screen_mult_min)
        self.hi = float(cfg.screen_mult_max)
        self.mult = float(np.float32(
            min(max(float(cfg.screen_norm_mult), self.lo), self.hi)))
        self.rounds_observed = 0

    def plan_mult(self) -> float:
        """The multiplier the next round runs with, float32-rounded."""
        return float(np.float32(self.mult))

    def plan_value(self) -> float:
        return self.plan_mult()

    def install(self, value) -> None:
        self.mult = float(value)

    def observe(self, round_idx: int, n_screened: int,
                n_cohort: int) -> Optional[tuple]:
        """Feed one committed round's screened count (every round, zero
        included: the trajectory is a function of the stream). Returns
        (old, new, rate) when the multiplier moved, else None."""
        del round_idx
        self.rounds_observed += 1
        rate = float(n_screened) / float(max(int(n_cohort), 1))
        old = self.plan_mult()
        if rate > self.target:
            new = min(old * (1.0 + self.step), self.hi)
        elif rate < self.target:
            new = max(old / (1.0 + self.step), self.lo)
        else:
            new = old
        new = float(np.float32(new))
        self.mult = new
        if new != old:
            return (old, new, rate)
        return None

    def state_dict(self) -> dict:
        return {"screen_mult": np.float64(self.mult),
                "screen_rounds_observed": np.int64(self.rounds_observed)}

    def load_state_dict(self, state: dict) -> None:
        if "screen_mult" in state:
            self.mult = float(np.asarray(state["screen_mult"]))
            self.rounds_observed = int(np.asarray(
                state.get("screen_rounds_observed", 0)))
