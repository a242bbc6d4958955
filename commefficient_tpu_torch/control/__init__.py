"""Plan-riding feedback controllers: the port of
commefficient_tpu/control.

  base.py       the Controller contract, ControllerBank, CONTROL_FIELDS
  screen.py     AdaptiveScreenController (--target_screened_rate)
  speed.py      SpeedMatchController (--speed_match)
  span.py       SpanCadenceController (--scan_span_palette)
  staleness.py  StalenessDecayController (--adapt_staleness)

`make_bank` builds the run's bank from the flags, or None when none is
set, so a default run builds nothing. The screen controller is not in
the bank: FedModel holds it as `screen_ctl`, and its value rides
`RoundPlan.screen_mult`.
"""
from __future__ import annotations

from commefficient_tpu_torch.control.base import (
    CONTROL_FIELDS, Adjustment, Controller, ControllerBank, control_field,
)
from commefficient_tpu_torch.control.screen import AdaptiveScreenController
from commefficient_tpu_torch.control.span import SpanCadenceController
from commefficient_tpu_torch.control.speed import SpeedMatchController
from commefficient_tpu_torch.control.staleness import (
    StalenessDecayController,
)

__all__ = [
    "Adjustment", "AdaptiveScreenController", "CONTROL_FIELDS",
    "Controller", "ControllerBank", "SpanCadenceController",
    "SpeedMatchController", "StalenessDecayController", "control_field",
    "make_bank",
]


def make_bank(cfg):
    """The run's ControllerBank, or None when no bank controller's flag
    is set."""
    controllers = []
    if cfg.speed_match:
        controllers.append(SpeedMatchController(cfg))
    if cfg.span_palette:
        controllers.append(SpanCadenceController(cfg))
    if cfg.adapt_staleness:
        controllers.append(StalenessDecayController(cfg))
    if not controllers:
        return None
    return ControllerBank(controllers)
