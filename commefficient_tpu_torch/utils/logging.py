"""Run logging for the port's drivers: the stdout table, the interval
timer and the run directory name of commefficient_tpu/utils/logging.py
(reference utils.py:14-99)."""
from __future__ import annotations

import os
import time
from datetime import datetime

import numpy as np


class TableLogger:
    """Fixed-width column table on stdout, header from the first row;
    new keys append a column and reprint the header, missing keys print
    '-'."""

    _MISSING = object()

    def append(self, output: dict):
        fresh = [k for k in output if k not in getattr(self, "keys", ())]
        if not hasattr(self, "keys"):
            self.keys = list(fresh)
            print(*(f"{k:>12s}" for k in self.keys))
        elif fresh:
            self.keys.extend(fresh)
            print(*(f"{k:>12s}" for k in self.keys))
        row = []
        for k in self.keys:
            v = output.get(k, self._MISSING)
            if v is self._MISSING:
                row.append(f"{'-':>12}")
            elif isinstance(v, (float, np.floating)):
                row.append(f"{v:12.4f}")
            else:
                row.append(f"{v!s:>12}")
        print(*row)


class SilentLogger:
    """A logger that records nothing: the table of a rank that is not
    the coordinator."""

    def append(self, output: dict):
        pass


class Timer:
    """Interval timer on the monotonic clock."""

    def __init__(self):
        self.times = [time.monotonic()]
        self.total_time = 0.0

    def __call__(self, include_in_total=True):
        self.times.append(time.monotonic())
        dt = self.times[-1] - self.times[-2]
        if include_in_total:
            self.total_time += dt
        return dt


def make_logdir(cfg) -> str:
    """runs/<time>_<workers>/<clients>_<mode geometry>_<k>: the
    reference's run directory name (its literal slash nests it two
    deep)."""
    mode = cfg.mode
    sketch_str = (f"{mode}: {cfg.num_rows} x {cfg.num_cols}"
                  if mode == "sketch" else f"{mode}")
    k_str = (f"k: {cfg.k}"
             if mode in ("sketch", "true_topk", "local_topk") else "")
    clients_str = f"{cfg.num_workers}/{cfg.num_clients}"
    now = datetime.now().strftime("%b%d_%H-%M-%S")
    return os.path.join(
        "runs", f"{now}_{clients_str}_{sketch_str}_{k_str}")
