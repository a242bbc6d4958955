"""The analysis tiers' host half: the port of commefficient_tpu/
analysis/ for the code that runs on the host.

  * `engine` + `rules`: graftlint's host rules (``python -m
    commefficient_tpu_torch.analysis [paths]``): GL005 fault-swallowing
    broad excepts, GL006 non-atomic file writes, GL009 PRNG domain tags
    outside the registry, GL011 wall-clock deltas used as durations,
    GL012 anonymous threads, GL014 controller wire fields outside the
    registry. Per-line ``# graftlint: disable=GLxxx -- reason``.
  * `syncaudit`: graftsync (``python -m
    commefficient_tpu_torch.analysis.syncaudit``): the shared-state
    guards, the static lock order, queue ownership, blocking under a
    lock, thread joins and the happens-before edges of
    `domains.ORDERING_EDGES` over the port's seven host packages (rules
    SY001-SY006).
  * `domains`: the registries (PRNG domains, controller wire fields,
    shared state, ordering edges), stdlib only.
  * `runtime`: the sanitizers tests and chip_smoke.py arm: the
    LockOrderSanitizer (the observed lock-acquisition graph asserted
    acyclic, graftsync's runtime twin), `interleaving_stress` (a
    deterministic stagger of queue handoffs) and the NumericSanitizer
    (a finite guard on every exported round metric, and the replay
    drill).

The lint and the audit are pure `ast` plus the stdlib; only `runtime`
touches torch, lazily. The JAX package's trace tiers (graftaudit and
its cost model, graftmesh, graftnum, the program counter and the
transfer guard) and its rules over traced code have torch counterparts
still to come (ROADMAP.md item 10f).
"""
from commefficient_tpu_torch.analysis.engine import (  # noqa: F401
    Baseline, LintError, Violation, lint_paths, lint_source,
)
from commefficient_tpu_torch.analysis.rules import (  # noqa: F401
    ALL_RULES, RULE_DOCS,
)
