"""The analysis tiers: the port of commefficient_tpu/analysis/.

Host code (pure `ast` plus the stdlib, seconds, offline):
  * `engine` + `rules`: graftlint (``python -m
    commefficient_tpu_torch.analysis [paths]``), every JAX rule code:
    the host rules GL005 fault-swallowing broad excepts, GL006
    non-atomic file writes, GL009 PRNG domain tags outside the registry,
    GL011 wall-clock deltas used as durations, GL012 anonymous threads,
    GL014 controller wire fields outside the registry; and the rules
    over the round's path (the port's traced code) GL001 host clocks and
    unseeded RNG, GL002 host syncs, GL003 a threefry key drawn twice,
    GL004 control flow over tensors, GL008 large exact top-k, GL013
    float equality, with GL007 raw collectives outside the rank layer
    and GL010 axis names outside MESH_AXES. Per-line ``# graftlint:
    disable=GLxxx -- reason``.
  * `syncaudit`: graftsync (``python -m
    commefficient_tpu_torch.analysis.syncaudit``), SY001-SY006 over the
    port's seven host packages.
  * `domains`: the registries (PRNG domains, controller wire fields,
    mesh axes, precision seams, shared state, ordering edges).

Recorded rounds (torch, the CPU by default; the trace tiers' port):
  * `recorder`: the RoundRecorder, a TorchDispatchMode over one round
    (every aten op with its shapes, dtypes, devices, value ids and
    stage); the kernel regions each kernel wrapper opens (one entry with
    the bytes and operations its bound counts) and the round stages are
    the leaf module commefficient_tpu_torch/hooks.py, which the round's
    path imports without loading the tiers.
  * `costmodel`: FLOPs and bytes of recorded ops (the JAX `jaxpr_cost`
    rules), and the collective model over a Layout's call log.
  * `audit`: graftaudit (``python -m ...analysis.audit``), AU001-AU006
    over the audit configs, baseline `baselines/audit.json`.
  * `numaudit`: graftnum (``... .numaudit``), NU001-NU005, baseline
    `baselines/graftnum.json`.
  * `shardaudit`: graftmesh (``... .shardaudit``), AU007, AU008, AU010
    over 2-rank gloo worlds, baseline `baselines/meshaudit.json`.
    Every tier exits 0 clean, 1 violations, 2 baseline drift, 3 usage.
  * `runtime`: the sanitizers tests and chip_smoke.py arm: the
    LockOrderSanitizer, `interleaving_stress`, the NumericSanitizer, the
    implicit-sync guard `forbid_transfers` behind --debug_transfer_guard
    (with `explicit_transfer`) and the program counter
    (`count_programs`, `assert_program_count`).

The baselines are the port's own: its rounds dispatch aten ops and
kernel entries, not XLA equations, so their prices are not the JAX
package's *.baseline.json. Only `runtime`, `recorder` and the three
recorded tiers touch torch, lazily.
"""
from commefficient_tpu_torch.analysis.engine import (  # noqa: F401
    Baseline, LintError, Violation, lint_paths, lint_source,
)
from commefficient_tpu_torch.analysis.rules import (  # noqa: F401
    ALL_RULES, RULE_DOCS,
)
