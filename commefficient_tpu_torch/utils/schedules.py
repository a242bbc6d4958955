"""Learning-rate schedules: the port's copy of the CV driver's part of
commefficient_tpu/utils/schedules.py (reference utils.py:26-35),
driven through LambdaLR against the FedOptimizer's param_groups."""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np


class PiecewiseLinear(NamedTuple):
    knots: Sequence[float]
    vals: Sequence[float]

    def __call__(self, t):
        return float(np.interp([t], self.knots, self.vals)[0])


class LambdaLR:
    """step()/get_last_lr() driver, one per optimizer param group."""

    def __init__(self, optimizer, lr_lambda: Callable[[int], float]):
        self.optimizer = optimizer
        self.lr_lambda = lr_lambda
        self.step_count = 0
        self._apply()

    def _apply(self):
        lr = self.lr_lambda(self.step_count)
        for group in self.optimizer.param_groups:
            group["lr"] = lr * group.get("lr_scale", 1.0)

    def step(self):
        self.step_count += 1
        self._apply()

    def get_last_lr(self):
        return [g["lr"] for g in self.optimizer.param_groups]

    def state_dict(self):
        return {"step_count": self.step_count}

    def load_state_dict(self, state):
        self.step_count = int(state["step_count"])
        self._apply()
