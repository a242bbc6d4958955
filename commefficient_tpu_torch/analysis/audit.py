"""graftaudit: the port of commefficient_tpu/analysis/audit.py, over
recorded rounds instead of traced programs.

The JAX tier traces the round programs to ClosedJaxprs; the port has no
traced program, so it DRIVES one round of each audit config through the
real round factory (federated/round.make_train_fn, what FedModel
dispatches) under a `recorder.RoundRecorder` and walks the recorded
ops. A round's three stages are the JAX engine's three programs: the
cohort round (`{config}/{variant}`) and the two state-motion programs
around it (`{config}/gather`, `{config}/scatter`). The rules keep the
JAX codes:

  AU001  an implicit device-to-host sync inside the round
         (runtime.sync_kind on the audit device: a scalar read, a
         blocking copy to the host, an op whose output shape is data):
         the per-round stall GL002 hunts in the source.
  AU002  a float64 / complex128 value inside the round: the engine's
         numeric contract is f32 state with bf16/int8 options.
  AU003  an exact `topk` with k >= TOPK_MIN_K, or a `sort` along a
         dimension of SORT_MIN_N or more: the GL008 class, after every
         route the config takes.
  AU004  a population-shaped value (the AUDIT_POPULATION sentinel in
         its shape) in the cohort round: the round operates on cohort
         rows only. The state-motion programs keep the JAX inventory
         semantics: their population-shaped inputs are the named
         client-state map.
  AU005  a dead round input not updated in place: a state-motion
         program that allocates a population-shaped buffer (the
         [population, D] rows copied whole instead of written through
         index_put_ / index_copy_), the port's reading of JAX's
         undonated dispatch operand.
  AU006  cost drift (costmodel.records_cost) against the port's own
         baseline, analysis/baselines/audit.json, exact match by
         default: a new program, a stale entry or a moved price.

Kernel entries (hooks.kernel_region) carry the kernels' own bytes
and operations, so the CPU's report (the plain versions run, their
ops left out) and the card's record the same kernels.

The baseline is the port's own: the port's rounds dispatch aten ops and
kernel entries, not XLA equations, so their prices differ from the JAX
package's audit.baseline.json, which stays the JAX package's.

CLI: ``python -m commefficient_tpu_torch.analysis.audit`` (from the
repo root; `--device cuda` audits on the card). Exit codes are JAX's:
0 clean, 1 rule violations, 2 baseline drift only, 3 usage. The report
is canonical JSON with a sha256 digest, bit-identical across runs; with
`--journal` it is appended as an `audit_digest` event.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from commefficient_tpu_torch.analysis.costmodel import (
    base_op, meta_bytes, records_cost, sort_width,
)

AUDIT_RULE_DOCS = {
    "AU001": "implicit device-to-host sync (scalar read / blocking copy "
             "to the host / data-dependent output shape) inside the round",
    "AU002": "f64/c128 dtype inside the round (engine contract is f32 "
             "state, bf16/int8 compute/wire)",
    "AU003": "exact sort/topk over a large operand (the GL008 sorting "
             "cliff, after every route the config takes)",
    "AU004": "population-scaling value in the cohort round (not a "
             "state-motion client-state input)",
    "AU005": "dead round input not updated in place (population-shaped "
             "client rows copied whole in a state-motion program)",
    "AU006": "cost drift vs analysis/baselines/audit.json (new / stale / "
             "moved program)",
}

# AU003 thresholds: the JAX package's
TOPK_MIN_K = 2048          # == rules.GL008_MIN_K (kept in sync by test)
SORT_MIN_N = 1 << 16

# the population sentinel: prime, distinct from every geometry dimension
AUDIT_POPULATION = 23

# the workload geometry the baseline prices (the JAX package's)
AUDIT_GEOMETRY = dict(D=1024, W=8, B=4, k=64, rows=3, cols=256)

# the tiered config's device working set (the JAX package's)
TIER_WORKING_SET = 16

# the JAX engine's round programs: the three default treedefs, or the
# screened family's two
PROGRAM_VARIANTS = ("mask_free", "dropout", "dropout_stragglers")
SCREENED_PROGRAM_VARIANTS = ("screened", "screened_stragglers")
STATE_MOTION_PROGRAMS = ("gather", "scatter")

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baselines", "audit.json")


@dataclasses.dataclass(frozen=True, order=True)
class AuditFinding:
    program: str
    rule: str
    message: str

    def render(self) -> str:
        return f"{self.program}: {self.rule} {self.message}"


def program_variants_for(cfg) -> tuple:
    """The round programs a config dispatches (the JAX package's
    round.program_variants_for)."""
    from commefficient_tpu_torch.federated.round import screened_family
    return (SCREENED_PROGRAM_VARIANTS if screened_family(cfg)
            else PROGRAM_VARIANTS)


def batch_variants(batch, cfg) -> dict:
    """The RoundBatch of each program variant, from one batch: inert
    fault operands (all survive, half work, nobody poisoned, screen on),
    the JAX package's round.audit_batch_variants."""
    import torch
    W = batch.client_ids.shape[0]
    dev = batch.mask.device
    ones = torch.ones(W, dtype=torch.float32, device=dev)
    if program_variants_for(cfg) == SCREENED_PROGRAM_VARIANTS:
        zeros = torch.zeros_like(ones)
        on = torch.ones((), dtype=torch.float32, device=dev)
        return {
            "screened": batch._replace(survivors=ones, work=None,
                                       poison=zeros, screen=on),
            "screened_stragglers": batch._replace(
                survivors=ones, work=ones * 0.5, poison=zeros, screen=on),
        }
    return {
        "mask_free": batch._replace(survivors=None, work=None,
                                    poison=None, screen=None),
        "dropout": batch._replace(survivors=ones, work=None, poison=None,
                                  screen=None),
        "dropout_stragglers": batch._replace(survivors=ones,
                                             work=ones * 0.5, poison=None,
                                             screen=None),
    }


# ---------------------------------------------------------------------------
# findings over recorded ops


def _has_pop(meta, population: int) -> bool:
    return population in meta[0]


def forbidden_op_findings(program: str, records, device: str = "cpu"
                          ) -> List[AuditFinding]:
    """AU001 + AU002 + AU003 over one program's records."""
    from commefficient_tpu_torch.analysis.runtime import sync_kind
    out: List[AuditFinding] = []
    for rec in records:
        if rec.kernel is not None:
            continue
        kind = sync_kind(rec.op, rec.ins, rec.scalars, rec.kwargs, device)
        if kind is not None:
            out.append(AuditFinding(
                program, "AU001",
                f"{kind} `{rec.op}` inside the round: a per-round "
                "device-to-host sync; keep the value on the device (the "
                "telemetry and accounting boundaries copy one round "
                "late, outside the round)"))
        for m in rec.ins + rec.outs:
            if m[1] in ("float64", "complex128"):
                out.append(AuditFinding(
                    program, "AU002",
                    f"{m[1]} value of shape {m[0]} at `{rec.op}`: the "
                    "engine's numeric contract is f32 state / bf16-int8 "
                    "compute; a float64 is an accidental promotion "
                    "(doubled memory, slow on the card)"))
                break
        op = base_op(rec.op)
        if op == "topk":
            k = next((s for s in rec.scalars if isinstance(s, int)
                      and not isinstance(s, bool)), 0)
            if k >= TOPK_MIN_K:
                out.append(AuditFinding(
                    program, "AU003",
                    f"exact `topk` with k={k} over {rec.ins[0][0]}: a "
                    "sorting network over the operand; select by the "
                    "sampled threshold (ops/flat.masked_topk) or the "
                    "fused decode"))
        elif op == "sort":
            width = sort_width(rec)
            if width >= SORT_MIN_N:
                out.append(AuditFinding(
                    program, "AU003",
                    f"exact `sort` along a {width}-wide dimension inside "
                    "the round: the sorting cliff; use the sampled "
                    "threshold or a fused kernel (a sort along a short "
                    "dimension, the median's r-wide sort, is not "
                    "flagged)"))
    return sorted(out)


def population_scan(program: str, records, population: int,
                    names: Dict[int, str], strict: bool = False
                    ) -> Tuple[dict, List[AuditFinding]]:
    """AU004 / AU005 and the named client-state inventory.

    strict (the cohort round): any population-shaped value, input or
    output, is AU004. Otherwise (the state-motion programs) the
    population-shaped inputs are the inventory, a population-shaped
    output that aliases its input is the in-place write, and one that
    allocates is AU005."""
    inventory = {"inputs": []}
    seen = set()
    findings: List[AuditFinding] = []
    for rec in records:
        if rec.kernel is not None:
            continue
        for vid, m in zip(rec.in_vids, rec.ins):
            if not _has_pop(m, population):
                continue
            if strict:
                findings.append(AuditFinding(
                    program, "AU004",
                    f"population-shaped operand {list(m[0])} of "
                    f"`{rec.op}`: the round takes cohort rows only — "
                    "population state moves through the gather / "
                    "scatter state-motion programs"))
            elif vid in names and vid not in seen:
                seen.add(vid)
                inventory["inputs"].append({
                    "name": names[vid], "shape": list(m[0]),
                    "dtype": m[1], "bytes": meta_bytes(m)})
        for m in rec.outs:
            if not _has_pop(m, population):
                continue
            if strict:
                findings.append(AuditFinding(
                    program, "AU004",
                    f"population-shaped value {list(m[0])} produced by "
                    f"`{rec.op}` inside the round: it materializes a "
                    "num_clients-scaling buffer a round"))
            elif rec.allocates:
                findings.append(AuditFinding(
                    program, "AU005",
                    f"`{rec.op}` allocates a population-shaped "
                    f"{list(m[0])} buffer: the client rows are dead "
                    "after the round and must be written in place "
                    "(index_put_ / index_copy_), never copied whole"))
    inventory["inputs"].sort(key=lambda e: e["name"])
    return inventory, sorted(findings)


# ---------------------------------------------------------------------------
# the audit workload: a linear model through the real round factory


def audit_configs(population: int = AUDIT_POPULATION):
    """(name, Config) pairs, the JAX package's names on the port's one
    kernel route (`sketch-cuda`: the CUDA kernels on the card, their
    plain versions on the CPU)."""
    from commefficient_tpu_torch.config import Config
    g = AUDIT_GEOMETRY
    base = dict(weight_decay=0.0, num_workers=g["W"], microbatch_size=-1,
                grad_size=g["D"], num_clients=population, seed=0)
    sketch = dict(mode="sketch", error_type="virtual", virtual_momentum=0.9,
                  local_momentum=0.0, k=g["k"], num_rows=g["rows"],
                  num_cols=g["cols"], num_blocks=1)
    return [
        ("sketch-cuda", Config(**sketch, **base).validate()),
        ("client-state", Config(
            mode="local_topk", error_type="local", local_momentum=0.9,
            do_topk_down=True, k=g["k"], down_k=32, **base).validate()),
        ("client-state-tiered", Config(
            mode="local_topk", error_type="local", local_momentum=0.9,
            do_topk_down=True, k=g["k"], down_k=32, state_tier="host",
            state_working_set=TIER_WORKING_SET, **base).validate()),
        ("sketch-screened", Config(
            **sketch, update_screen="norm", **base).validate()),
        ("sketch-robust", Config(
            **sketch, update_screen="norm", byzantine_rate=0.2,
            attack="sign_flip", aggregator="trimmed_mean",
            **base).validate()),
        ("powersgd", Config(
            mode="powersgd", error_type="local", local_momentum=0.0,
            powersgd_rank=2, **base).validate()),
        ("dp-sketch", Config(
            mode="dp_sketch", error_type="virtual", virtual_momentum=0.9,
            local_momentum=0.0, k=g["k"], num_rows=g["rows"],
            num_cols=g["cols"], num_blocks=1, dp_clip=1.0,
            dp_noise_mult=1.0, **base).validate()),
    ]


def linear_loss(params, batch, mask):
    """The JAX audit's workload loss: 0.5 (x . w - y)^2, masked mean."""
    import torch
    x, y = batch
    pred = x @ params["w"]
    per_ex = 0.5 * (pred - y) ** 2
    denom = torch.clamp(mask.sum(), min=1.0)
    return (per_ex * mask).sum() / denom, ((per_ex * mask).sum() / denom,)


def _unravel(vec):
    return {"w": vec}


def build_workload(cfg, device="cpu"):
    """(train_round, server, clients, variants, lr, key) for one config:
    the real round factory on a [D] linear model, the batch made from a
    seed with numpy."""
    import numpy as np
    import torch

    from commefficient_tpu_torch.federated import round as fround
    from commefficient_tpu_torch.ops.prng import PRNGKey
    g = AUDIT_GEOMETRY
    dev = torch.device(device)
    rng = np.random.RandomState(0)
    train_round = fround.make_train_fn(linear_loss, _unravel, cfg)
    vec = torch.from_numpy(
        (rng.randn(g["D"]) * 0.01).astype(np.float32)).to(dev)
    server = fround.init_server_state(cfg, vec)
    rows = fround.client_state_rows(cfg, AUDIT_POPULATION)
    clients = fround.init_client_state(cfg, rows, dev, vec)
    ids = (np.arange(g["W"]) * 2 % rows).astype(np.int64)
    x = rng.randn(g["W"], g["B"], g["D"]).astype(np.float32)
    y = rng.randn(g["W"], g["B"]).astype(np.float32)
    batch = fround.RoundBatch(
        torch.from_numpy(ids).to(dev),
        (torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)),
        torch.ones((g["W"], g["B"]), dtype=torch.float32, device=dev))
    return (train_round, server, clients, batch_variants(batch, cfg), 0.1,
            PRNGKey(0))


def record_round(cfg, variant: str, device="cpu", rounds: int = 1):
    """The RoundRecorder of `rounds` rounds of `variant` back to back on
    fresh state (several: the port's span, the per-round path op for
    op)."""
    from commefficient_tpu_torch.analysis.recorder import RoundRecorder
    train_round, server, clients, variants, lr, key = build_workload(
        cfg, device)
    rec = RoundRecorder()
    with rec:
        rec.name_inputs("server", server)
        rec.name_inputs("clients", clients)
        rec.name_inputs("batch", variants[variant])
        for _ in range(rounds):
            server, clients, _m = train_round(server, clients,
                                              variants[variant], lr, key)
    return rec


def op_counts(records) -> Dict[str, int]:
    """{op or kernel name: count} of one program's records."""
    out: Dict[str, int] = {}
    for r in records:
        name = "kernel." + r.kernel.name if r.kernel is not None else r.op
        out[name] = out.get(name, 0) + 1
    return dict(sorted(out.items()))


def program_records(rec, program: str):
    """The records of one program of a recorded round: the state-motion
    stage, or the round stage for a variant."""
    stage = program if program in STATE_MOTION_PROGRAMS else "round"
    return [r for r in rec.records if r.stage == stage]


def audit_program(prog: str, records, names, device: str, strict: bool
                  ) -> Tuple[dict, List[AuditFinding]]:
    findings = forbidden_op_findings(prog, records, device)
    inventory, pop = population_scan(prog, records, AUDIT_POPULATION, names,
                                     strict=strict)
    cost = records_cost(records)
    return ({"cost": cost.as_dict(), "population_inventory": inventory,
             "kernels": [r.kernel.name for r in records
                         if r.kernel is not None],
             "ops": op_counts(records)},
            findings + pop)


# ---------------------------------------------------------------------------
# baseline (the JAX package's exact-match diff, the port's own copy)


class AuditBaseline:
    """{"violations": [{program, rule, count, justification}], "costs":
    {program: {flops, hbm_bytes}}}: new hits and stale entries both
    error. COST_KEY / COST_FIELDS / DRIFT_RULE parameterize the cost
    block for graftnum and graftmesh, as in the JAX package."""

    COST_KEY = "costs"
    COST_FIELDS = ("flops", "hbm_bytes")
    DRIFT_RULE = "AU006"

    def __init__(self, violations=None, costs=None):
        self.violations: Dict[Tuple[str, str], Tuple[int, str]] = dict(
            violations or {})
        self.costs: Dict[str, dict] = dict(costs or {})

    @classmethod
    def load(cls, path: str) -> "AuditBaseline":
        with open(path, encoding="utf-8") as f:
            raw = json.load(f)
        violations = {(e["program"], e["rule"]): (
            int(e["count"]), e.get("justification", ""))
            for e in raw.get("violations", ())}
        return cls(violations, raw.get(cls.COST_KEY, {}))

    def dump(self, path: str) -> None:
        doc = {
            "version": 1,
            "violations": [
                {"program": p, "rule": r, "count": n, "justification": j}
                for (p, r), (n, j) in sorted(self.violations.items())],
            self.COST_KEY: {k: self.costs[k] for k in sorted(self.costs)},
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(json.dumps(doc, indent=2) + "\n")
        os.replace(tmp, path)

    def apply_violations(self, findings: Sequence[AuditFinding]
                         ) -> Tuple[List[AuditFinding], List[str]]:
        by_key: Dict[Tuple[str, str], List[AuditFinding]] = {}
        for f in findings:
            by_key.setdefault((f.program, f.rule), []).append(f)
        new: List[AuditFinding] = []
        stale: List[str] = []
        for key, fs in sorted(by_key.items()):
            if len(fs) > self.violations.get(key, (0, ""))[0]:
                new.extend(fs)
        for key, (count, _) in sorted(self.violations.items()):
            have = len(by_key.get(key, ()))
            if have < count:
                stale.append(
                    f"stale baseline entry {key[0]} {key[1]}: "
                    f"grandfathers {count}, audit found {have} — "
                    "regenerate with --write-baseline")
        return new, stale

    def apply_costs(self, costs: Dict[str, dict],
                    tolerance: float) -> List[AuditFinding]:
        out: List[AuditFinding] = []
        for prog in sorted(costs):
            got = costs[prog]
            base = self.costs.get(prog)
            if base is None:
                summary = ", ".join(f"{f}={got[f]}"
                                    for f in self.COST_FIELDS)
                out.append(AuditFinding(
                    prog, self.DRIFT_RULE,
                    f"no baseline for this program ({summary}); a new "
                    "program must be priced deliberately — run "
                    "--write-baseline and commit the diff"))
                continue
            for field in self.COST_FIELDS:
                want, have = int(base.get(field, 0)), int(got[field])
                if not (want * (1.0 - tolerance) <= have
                        <= want * (1.0 + tolerance)):
                    direction = "regressed" if have > want else "moved"
                    out.append(AuditFinding(
                        prog, self.DRIFT_RULE,
                        f"static {field} {direction}: baseline {want}, "
                        f"recorded {have} "
                        f"({(have - want) / max(want, 1):+.1%}, "
                        f"tolerance ±{tolerance:.1%}); if intentional, "
                        "--write-baseline and commit the diff"))
        for prog in sorted(self.costs):
            if prog not in costs:
                out.append(AuditFinding(
                    prog, self.DRIFT_RULE,
                    "stale baseline: program no longer recorded by the "
                    "audit — regenerate with --write-baseline"))
        return out


def split_findings(findings: Sequence[AuditFinding], drift_rule: str
                   ) -> Tuple[List[AuditFinding], List[AuditFinding]]:
    """(rule violations, baseline drift)."""
    return ([f for f in findings if f.rule != drift_rule],
            [f for f in findings if f.rule == drift_rule])


def exit_code(violations: Sequence, drift: Sequence,
              stale: Sequence) -> int:
    """0 clean, 1 rule violations, 2 baseline drift only."""
    if violations:
        return 1
    if drift or stale:
        return 2
    return 0


def canonical_digest(block: dict) -> str:
    """sha256 of a canonical-JSON block: the bit-identical claim."""
    return hashlib.sha256(json.dumps(
        block, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


# ---------------------------------------------------------------------------
# the full audit


def run_audit(device: str = "cpu") -> Tuple[dict, List[AuditFinding]]:
    """Record every audit config x (its round variants + the two
    state-motion programs, taken from the first variant's round);
    returns (report, findings). AU006 is the caller's baseline diff."""
    programs: Dict[str, dict] = {}
    findings: List[AuditFinding] = []
    for cfg_name, cfg in audit_configs():
        for i, variant in enumerate(program_variants_for(cfg)):
            rec = record_round(cfg, variant, device)
            motion = STATE_MOTION_PROGRAMS if i == 0 else ()
            for name in (variant,) + motion:
                prog = f"{cfg_name}/{name}"
                entry, fs = audit_program(
                    prog, program_records(rec, name), rec.names, device,
                    strict=name not in STATE_MOTION_PROGRAMS)
                programs[prog] = entry
                findings.extend(fs)
    report = {
        "version": 1,
        "geometry": dict(AUDIT_GEOMETRY, population=AUDIT_POPULATION),
        "programs": {p: programs[p] for p in sorted(programs)},
        "costs": {p: {"flops": d["cost"]["flops"],
                      "hbm_bytes": d["cost"]["hbm_bytes"]}
                  for p, d in sorted(programs.items())},
    }
    report["digest"] = canonical_digest(
        {"geometry": report["geometry"], "costs": report["costs"]})
    return report, sorted(findings)


def journal_digest(journal_path: str, report: dict,
                   findings_count: int) -> dict:
    """Append the report as an `audit_digest` journal event."""
    from commefficient_tpu_torch.telemetry.journal import append_event
    return append_event(journal_path, "audit_digest",
                        digest=report["digest"],
                        geometry=report["geometry"],
                        programs=report["costs"],
                        findings=int(findings_count))


def grandfather(findings: Sequence[AuditFinding]) -> dict:
    counts: Dict[Tuple[str, str], int] = {}
    for f in findings:
        counts[(f.program, f.rule)] = counts.get((f.program, f.rule), 0) + 1
    return {k: (n, "TODO: justify or fix") for k, n in counts.items()}


def finish(prog: str, args, report: dict, findings, baseline_cls,
           cost_key: str, journal, tolerance: float = 0.0) -> int:
    """The tiers' shared CLI tail: the baseline diff (or its rewrite),
    the report, the journal event, the findings and the exit code."""
    if args.write_baseline:
        old = (baseline_cls.load(args.baseline)
               if os.path.exists(args.baseline) else baseline_cls())
        violations = grandfather(findings)
        for key, (n, why) in violations.items():
            if key in old.violations and old.violations[key][0] == n:
                violations[key] = (n, old.violations[key][1])
        baseline_cls(violations, report[cost_key]).dump(args.baseline)
        print(f"{prog}: wrote {len(findings)} grandfathered finding(s) + "
              f"{len(report[cost_key])} program entr(ies) to "
              f"{args.baseline}")
        return 0
    stale: List[str] = []
    if not args.no_baseline:
        baseline = (baseline_cls.load(args.baseline)
                    if os.path.exists(args.baseline) else baseline_cls())
        new, stale = baseline.apply_violations(findings)
        findings = sorted(new + baseline.apply_costs(report[cost_key],
                                                     tolerance))
    if args.report:
        print(json.dumps(report, indent=2, sort_keys=True))
    if args.journal:
        journal(args.journal, report, len(findings))
    for f in findings:
        print(f.render())
    for msg in stale:
        print(f"{prog}: {msg}")
    violations, drift = split_findings(findings, baseline_cls.DRIFT_RULE)
    rc = exit_code(violations, drift, stale)
    if rc:
        print(f"{prog}: {len(violations)} violation(s), {len(drift)} "
              f"drift finding(s), {len(stale)} stale baseline entr(ies)")
        return rc
    print(f"{prog}: clean ({len(report[cost_key])} program(s) audited, "
          f"digest {report['digest'][:12]})")
    return 0


def common_args(ap: argparse.ArgumentParser, baseline: str) -> None:
    ap.add_argument("--baseline", default=baseline,
                    help="the port's baseline file (grandfathered "
                         "violations + committed per-program entries)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding and skip the diff")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from this run")
    ap.add_argument("--journal", default="",
                    help="append the report to this JSONL run journal")
    ap.add_argument("--report", action="store_true",
                    help="print the full JSON report")
    ap.add_argument("--list-rules", action="store_true")


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftaudit",
        description="recorded-round auditor of the port: implicit syncs, "
                    "f64, sort cliffs, population scaling, in-place "
                    "client rows, the cost baseline (rules AU001-AU006). "
                    "Exit codes: 0 clean, 1 violations, 2 drift only.")
    common_args(ap, DEFAULT_BASELINE)
    ap.add_argument("--cost-tolerance", type=float, default=0.0,
                    help="relative cost drift allowed before AU006")
    ap.add_argument("--device", default="cpu",
                    help="the device the rounds run on (cpu, cuda)")
    args = ap.parse_args(argv)
    if args.list_rules:
        for code, doc in sorted(AUDIT_RULE_DOCS.items()):
            print(f"{code}  {doc}")
        return 0
    if args.device not in ("cpu", "cuda"):
        print(f"graftaudit: unknown device {args.device!r}",
              file=sys.stderr)
        return 3
    report, findings = run_audit(args.device)
    return finish("graftaudit", args, report, findings, AuditBaseline,
                  "costs", journal_digest, args.cost_tolerance)


if __name__ == "__main__":
    sys.exit(main())
