"""Span cadence: the port of commefficient_tpu/control/span.py.

Under --scan_rounds the span length trades per-span host work
(checkpoint hooks, journal flushes, the dispatch's bookkeeping) against
how long the rounds wait to be staged. With --scan_span_palette the
length is picked from the palette instead of fixed by --scan_span:

  * every collected span feeds (rounds, wall seconds); the controller
    keeps an EMA of seconds a round for each palette length;
  * a warmup runs each palette length once, in ascending order (JAX
    traces each length's scanned program there; the port has no traced
    programs, and keeps the order so the picks are the same);
  * then the pick is the length with the least EMA (the shortest on a
    tie);
  * the stream's tail is cut greedily into palette lengths, the largest
    that fits down to 1 (Config.validate requires 1 in the palette).

Span seconds are wall-clock, so the pick is only ever decided on the
live path and is journaled (`control` events, and the `scan_span` field
of each plan). A span's rounds are the per-round path's in the port, so
no pick changes the weights.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from commefficient_tpu_torch.control.base import Adjustment, Controller

__all__ = ["SpanCadenceController"]

# the EMA's weight on the newest span
_CADENCE_ALPHA = 0.5


class SpanCadenceController(Controller):
    """Pick the span loop's span length from a palette."""

    NAME = "span_cadence"
    WIRE_FIELD = "scan_span"
    STATE_KEYS = ("choice", "spans_observed", "ema")
    provides_span_cap = True

    def __init__(self, cfg):
        self.palette = tuple(int(p) for p in cfg.span_palette)
        if not self.palette:
            raise ValueError("SpanCadenceController needs a non-empty "
                             "--scan_span_palette")
        self.choice = int(self.palette[0])
        self.spans_observed = 0
        # seconds a round for each palette entry; NaN = not tried yet
        self.ema = np.full(len(self.palette), np.nan, np.float64)

    def plan_value(self) -> int:
        return int(self.choice)

    def install(self, value) -> None:
        self.choice = int(value)

    def span_cap(self) -> int:
        """The length the next span is cut at."""
        return int(self.choice)

    def tail_cap(self, leftover: int) -> int:
        """The largest palette entry <= leftover."""
        fits = [p for p in self.palette if p <= int(leftover)]
        if not fits:
            return int(min(self.palette))
        return int(max(fits))

    def feed_span(self, round_idx: int, n_rounds: int,
                  seconds: float) -> Optional[Adjustment]:
        """One collected span's length and wall seconds; `round_idx` is
        its last round. Returns an Adjustment when the pick moves."""
        if int(n_rounds) <= 0:
            return None
        per_round = float(seconds) / float(n_rounds)
        if int(n_rounds) in self.palette:
            i = self.palette.index(int(n_rounds))
            if np.isnan(self.ema[i]):
                self.ema[i] = per_round
            else:
                self.ema[i] = (_CADENCE_ALPHA * per_round
                               + (1.0 - _CADENCE_ALPHA) * self.ema[i])
        self.spans_observed += 1
        old = int(self.choice)
        untried = [p for i, p in enumerate(self.palette)
                   if np.isnan(self.ema[i])]
        if untried:
            new = int(untried[0])
        else:
            new = int(self.palette[int(np.argmin(self.ema))])
        self.choice = new
        if new != old:
            # a palette pick is bounded by construction: never clamped
            return Adjustment(self.NAME, int(round_idx), float(per_round),
                              float(old), float(new), False)
        return None
