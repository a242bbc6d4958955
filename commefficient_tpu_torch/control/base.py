"""The controller contract and the bank that composes controllers: the
port of commefficient_tpu/control/base.py.

A controller is one bounded knob of a run that follows a measured
signal, in the one shape that keeps a resumed run bitwise:

  * it OBSERVES on the host: at plan-stamp (draw) time for wall-clock
    signals such as the throughput EMAs and the span seconds, at round
    commit for signals the round itself computes (a metric);
  * it moves by a BOUNDED step (multiplicative, clamped to [lo, hi],
    rounded to float32, so the journaled plan and the operand the
    round takes carry the same value);
  * the new value RIDES the round's plan (`RoundPlan.controls`, keyed
    by the controller's registered wire field, CONTROL_FIELDS) and is
    journaled in the plan's `schedule` event;
  * a plan's value is INSTALLED, never recomputed: the trajectory is a
    function of the plan stream, not of any process's clock;
  * its state rides the scheduler's checkpoint keys (`sched_*`, under
    `ctl_<name>_<key>`), so a resumed run continues it.

No controller changes what a round computes, only the values of
operands the round already takes (work fractions, the async
admission's decay, the span length the span loop flushes at); with no
controller flag set `control.make_bank` returns None and nothing here
runs.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

# controller name -> its RoundPlan wire field: the registry's (the JAX
# package's values), frozen (journals and checkpoints carry these
# names, and two controllers on one field would overwrite each other's
# journaled decisions)
from commefficient_tpu_torch.analysis.domains import CONTROL_FIELDS

__all__ = ["Adjustment", "CONTROL_FIELDS", "Controller", "ControllerBank",
           "control_field"]

def control_field(name: str) -> str:
    """The registered wire field of controller `name`; KeyError naming
    the registered controllers on a typo."""
    try:
        return CONTROL_FIELDS[name]
    except KeyError:
        raise KeyError(
            f"unknown controller {name!r}; registered: "
            f"{sorted(CONTROL_FIELDS)} (add new controllers to "
            "analysis/domains.CONTROL_FIELDS)") from None


class Adjustment(NamedTuple):
    """One journaled move, the payload of a `control` journal event."""
    controller: str   # Controller.NAME
    round_idx: int    # the round the move was decided at
    signal: float     # the observed signal that drove it
    old: float        # value before (float32-rounded)
    new: float        # value after (float32-rounded)
    clamped: bool     # True when the raw step hit a bound


class Controller:
    """One bounded, plan-riding knob. Subclasses set NAME and WIRE_FIELD
    (registered together in CONTROL_FIELDS), list their persisted
    attributes in STATE_KEYS and override the hooks they need:

      * stamp(round_idx, ids, ex, tracker): at draw time, on a fresh
        round only; returns (wire value, optional [W] work fractions
        min-composed onto plan.work, optional Adjustment);
      * observe_commit(round_idx, signals): at every committed round,
        replayed ones included, on signals the round computed;
      * feed_span(round_idx, n_rounds, seconds): at each collected span;
      * install(value): adopt a plan-carried value as the live state.
    """

    NAME = ""
    WIRE_FIELD = ""
    STATE_KEYS: Tuple[str, ...] = ()
    # the controller that owns the span loop's span length
    provides_span_cap = False
    # state that advances at round commit (collect order): a pipelined
    # span checkpoint saves it as it stands at save time, not the
    # dispatch-time snapshot (ControllerBank.commit_state_dict)
    COMMIT_STATE = False

    @staticmethod
    def _f32(x) -> float:
        return float(np.float32(x))

    def plan_value(self):
        """The value the next stamped plan carries."""
        raise NotImplementedError

    def install(self, value) -> None:
        """Adopt a plan-carried value."""
        raise NotImplementedError

    def stamp(self, round_idx: int, ids: np.ndarray, ex: np.ndarray,
              tracker) -> Tuple[object, Optional[np.ndarray],
                                Optional[Adjustment]]:
        del round_idx, ids, ex, tracker
        return self.plan_value(), None, None

    def observe_commit(self, round_idx: int,
                       signals: dict) -> Optional[Adjustment]:
        del round_idx, signals
        return None

    def feed_span(self, round_idx: int, n_rounds: int,
                  seconds: float) -> Optional[Adjustment]:
        del round_idx, n_rounds, seconds
        return None

    # -- the ctl_<name>_<key> checkpoint keys ------------------------------
    def _state_key(self, key: str) -> str:
        return f"ctl_{self.NAME}_{key}"

    def state_dict(self) -> dict:
        return {self._state_key(key): np.asarray(getattr(self, key))
                for key in self.STATE_KEYS}

    def load_state_dict(self, state: dict) -> None:
        # a checkpoint without the keys keeps the config's start point
        for key in self.STATE_KEYS:
            full = self._state_key(key)
            if full not in state:
                continue
            cur = getattr(self, key)
            v = np.asarray(state[full])
            if isinstance(cur, (bool, np.ndarray)):
                setattr(self, key, v)
            elif isinstance(cur, int):
                setattr(self, key, int(v))
            elif isinstance(cur, float):
                setattr(self, key, float(v))
            else:
                setattr(self, key, v)


class ControllerBank:
    """The run's controllers, in order. FedModel builds it
    (control.make_bank) and shares it with the RoundScheduler, which
    stamps every fresh plan through it; the model installs plan-carried
    values and feeds commits and spans; its state rides the `sched_*`
    keys. Adjustments queue here until the model journals them
    (take_events)."""

    def __init__(self, controllers):
        self.controllers: List[Controller] = list(controllers)
        self._by_field: Dict[str, Controller] = {}
        self._span_ctl: Optional[Controller] = None
        for c in self.controllers:
            if CONTROL_FIELDS.get(c.NAME) != c.WIRE_FIELD:
                raise ValueError(
                    f"controller {c.NAME!r} rides wire field "
                    f"{c.WIRE_FIELD!r}, but CONTROL_FIELDS registers "
                    f"{CONTROL_FIELDS.get(c.NAME)!r} — register the "
                    "field before shipping the controller")
            if c.WIRE_FIELD in self._by_field:
                raise ValueError(
                    f"two controllers share wire field {c.WIRE_FIELD!r}: "
                    f"{self._by_field[c.WIRE_FIELD].NAME!r} and "
                    f"{c.NAME!r}")
            self._by_field[c.WIRE_FIELD] = c
            if c.provides_span_cap:
                self._span_ctl = c
        self._events: List[Adjustment] = []

    @property
    def names(self) -> list:
        return [c.NAME for c in self.controllers]

    # -- the scheduler's side ----------------------------------------------
    def stamp_plan(self, plan, ids: np.ndarray, ex: np.ndarray, tracker):
        """Run every controller's draw-time hook, min-compose their work
        fractions onto plan.work and seal the wire values into
        plan.controls."""
        controls = {}
        work = plan.work
        for c in self.controllers:
            value, cwork, adj = c.stamp(int(plan.round_idx), ids, ex,
                                        tracker)
            controls[c.WIRE_FIELD] = value
            if cwork is not None:
                cwork = np.asarray(cwork, np.float32)
                work = (cwork if work is None
                        else np.minimum(np.asarray(work, np.float32),
                                        cwork))
            if adj is not None:
                self._events.append(adj)
        return plan._replace(work=work, controls=controls)

    # -- the model's side --------------------------------------------------
    def install(self, controls: dict) -> None:
        for field, value in controls.items():
            c = self._by_field.get(field)
            if c is not None:
                c.install(value)

    def observe_commit(self, round_idx: int, signals: dict) -> None:
        for c in self.controllers:
            adj = c.observe_commit(int(round_idx), signals)
            if adj is not None:
                self._events.append(adj)

    def feed_span(self, round_idx: int, n_rounds: int,
                  seconds: float) -> None:
        for c in self.controllers:
            adj = c.feed_span(int(round_idx), int(n_rounds),
                              float(seconds))
            if adj is not None:
                self._events.append(adj)

    def take_events(self) -> List[Adjustment]:
        events, self._events = self._events, []
        return events

    # -- the span loop's span length ---------------------------------------
    def span_cap(self, default: int) -> int:
        """The span length the span loop flushes at next: the span
        controller's pick, or `default`."""
        if self._span_ctl is None:
            return int(default)
        return int(self._span_ctl.span_cap())

    def tail_cap(self, leftover: int) -> int:
        """The palette's largest length <= leftover (the identity without
        a span controller), for cutting the stream's tail."""
        if self._span_ctl is None:
            return int(leftover)
        return int(self._span_ctl.tail_cap(int(leftover)))

    # -- checkpoint keys ---------------------------------------------------
    def state_dict(self) -> dict:
        out = {}
        for c in self.controllers:
            out.update(c.state_dict())
        return out

    def commit_state_dict(self) -> dict:
        """The COMMIT_STATE controllers' keys, which a pipelined span
        checkpoint reads as they stand at save time."""
        out = {}
        for c in self.controllers:
            if c.COMMIT_STATE:
                out.update(c.state_dict())
        return out

    def load_state_dict(self, state: dict) -> None:
        for c in self.controllers:
            c.load_state_dict(state)
