"""Rényi (moments-accountant) privacy tracking for dp_sketch: the port
of commefficient_tpu/compress/privacy.py, pure host math, unchanged.

Each dp_sketch round is one Gaussian mechanism release with noise
multiplier sigma = dp_noise_mult: the aggregated table has per-client
l2 sensitivity dp_clip and noise std dp_noise_mult * dp_clip, so in
normalized units the mechanism is N(0, sigma^2) on a sensitivity-1
query. Its Rényi divergence at order alpha is alpha / (2 sigma^2)
(Mironov 2017, Prop. 7); RDP composes additively over rounds, and the
standard conversion (Mironov 2017, Prop. 3) gives

    epsilon(T) = min_alpha [ T * alpha / (2 sigma^2)
                             + log(1/delta) / (alpha - 1) ]

over a fixed alpha grid, a pure function of (sigma, delta, T): a
resumed run re-derives the same budget from its round counter, with no
accountant state in the checkpoint. `closed_form_epsilon` is the exact
continuous-alpha minimum, which the grid answer hugs from above.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence


def default_alphas() -> tuple:
    """Dense steps near 1 plus the integer orders 11..64."""
    fine = tuple(1.0 + x / 10.0 for x in range(1, 100))
    coarse = tuple(float(a) for a in range(11, 65))
    return fine + coarse


def closed_form_epsilon(sigma: float, delta: float, steps: int) -> float:
    """T / (2 sigma^2) + sqrt(2 T log(1/delta)) / sigma, the exact
    continuous-alpha minimum."""
    if steps <= 0:
        return 0.0
    t = float(steps)
    return t / (2.0 * sigma * sigma) + math.sqrt(
        2.0 * t * math.log(1.0 / delta)) / sigma


class RdpAccountant:
    """Cumulative (epsilon, delta) of T composed Gaussian mechanism
    rounds at `noise_multiplier`; stateless, `epsilon(steps)` is a pure
    function of the step count."""

    def __init__(self, noise_multiplier: float, delta: float,
                 alphas: Optional[Sequence[float]] = None):
        if noise_multiplier <= 0:
            raise ValueError(
                f"noise_multiplier={noise_multiplier} must be > 0")
        if not 0.0 < delta < 1.0:
            raise ValueError(f"delta={delta} must be in (0, 1)")
        self.noise_multiplier = float(noise_multiplier)
        self.delta = float(delta)
        self.alphas = tuple(float(a) for a in
                            (alphas if alphas is not None
                             else default_alphas()))
        if any(a <= 1.0 for a in self.alphas):
            raise ValueError("all RDP orders must be > 1")

    def rdp(self, steps: int, alpha: float) -> float:
        """Composed Rényi divergence at order alpha after `steps`
        rounds."""
        s = self.noise_multiplier
        return steps * alpha / (2.0 * s * s)

    def epsilon(self, steps: int) -> float:
        """The (epsilon, self.delta)-DP guarantee after `steps` rounds:
        the minimum over the alpha grid of the RDP->DP conversion."""
        if steps <= 0:
            return 0.0
        log_inv_delta = math.log(1.0 / self.delta)
        return min(self.rdp(steps, a) + log_inv_delta / (a - 1.0)
                   for a in self.alphas)
