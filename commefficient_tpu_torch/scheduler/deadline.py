"""Deadline-driven rounds, the port of
commefficient_tpu/scheduler/deadline.py: how long a round may run.

The deadline is the `quantile` of the participants' finite estimated
seconds (telemetry/clients.estimate_round_seconds); a participant
estimated past it gets work fraction deadline / estimate, floored at
`min_work`, which rides the round's existing `work` operand (the
straggler path). Unmeasured participants are never truncated, and with
nothing measured there is no deadline. `overprovision` picks how many
clients to sample so that the expected survivors reach a target.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np

from commefficient_tpu_torch.telemetry.clients import ClientThroughputTracker


class DeadlineDecision(NamedTuple):
    """work: [n] f32 fractions in (0, 1], or None when nobody is
    truncated; deadline_s; est_round_s the slowest finite estimate;
    expected_round_s the slowest one under the deadline (None where
    unmeasured)."""
    work: Optional[np.ndarray]
    deadline_s: Optional[float]
    est_round_s: Optional[float]
    expected_round_s: Optional[float]


class DeadlinePolicy:
    def __init__(self, tracker: ClientThroughputTracker,
                 quantile: float, min_work: float = 0.1):
        if not 0.0 < quantile <= 1.0:
            raise ValueError(
                f"deadline quantile={quantile} must be in (0, 1]")
        if not 0.0 < min_work <= 1.0:
            raise ValueError(
                f"deadline min_work={min_work} must be in (0, 1] — "
                "zero work is dropout, not a deadline truncation")
        self.tracker = tracker
        self.quantile = float(quantile)
        self.min_work = float(min_work)

    def decide(self, client_ids, num_examples) -> DeadlineDecision:
        """The deadline and work fractions of one round's active slots."""
        est = self.tracker.estimate_round_seconds(client_ids,
                                                  num_examples)
        finite = np.isfinite(est) & (est > 0)
        if not finite.any():
            return DeadlineDecision(None, None, None, None)
        est_round_s = float(est[finite].max())
        deadline_s = float(np.quantile(est[finite], self.quantile))
        if deadline_s <= 0:
            return DeadlineDecision(None, None, est_round_s, None)
        over = finite & (est > deadline_s)
        if not over.any():
            return DeadlineDecision(None, deadline_s, est_round_s,
                                    est_round_s)
        work = np.ones(len(est), np.float32)
        work[over] = np.clip(deadline_s / est[over], self.min_work,
                             1.0).astype(np.float32)
        # a floored straggler still runs min_work x its estimate
        expected = float((est[finite] * work[finite]).max())
        return DeadlineDecision(work, deadline_s, est_round_s, expected)


def overprovision(target_survivors: int, num_slots: int,
                  num_alive: int, survival_rate: float) -> int:
    """ceil(target / survival_rate) clamped to [target, min(num_slots,
    num_alive)]; target 0 fills every slot."""
    if target_survivors <= 0:
        return min(num_slots, num_alive)
    s = min(max(float(survival_rate), 0.05), 1.0)
    n = max(int(target_survivors), math.ceil(target_survivors / s))
    return max(1, min(n, num_slots, num_alive))
