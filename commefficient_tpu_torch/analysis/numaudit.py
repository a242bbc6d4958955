"""graftnum: the port of commefficient_tpu/analysis/numaudit.py, over
recorded rounds.

The same walks as the JAX tier, on the ops a `recorder.RoundRecorder`
wrote while one round of each audit config ran (the programs of
analysis/audit: each round variant, the two state-motion programs, and
`span`, SPAN_LEN rounds back to back):

  NU001  NaN-unsafe mask arithmetic: a possibly non-finite tensor
         multiplied by a 0/1 mask (NaN * 0 is NaN; `where` is the
         guard). Finiteness is tracked per value from where the round
         introduces non-finiteness: a `where` / `full` with an inf or
         NaN constant, a division by a value not proven away from zero.
  NU002  a lossy cast (`_to_copy` / `copy_` to a narrower float, or a
         float to int8/int16) not registered in analysis/domains.
         PRECISION_SEAMS, or an error-feedback residual (a round input
         named `*err*`: server.Verror, clients.errors) below float32.
  NU003  a division, reciprocal, rsqrt or log whose argument is not
         proven away from zero, or a sqrt of a value not proven
         non-negative (the clamp(min > 0), eps-add and where idioms
         prove).
  NU004  replay nondeterminism on the card: an op whose CUDA kernel
         orders its float atomics freely (float index_add, scatter_add,
         index_put with accumulate, scatter_reduce sum/mean, cumsum,
         the convolution and embedding backwards, ... : the ops
         torch.use_deterministic_algorithms makes deterministic or
         refuses), unless deterministic algorithms were on; and an
         unstable sort or a topk whose INDICES the round then reads
         (the port's tie order is ops/flat.topk_indices' stable sort;
         a topk read for its values alone is deterministic).
  NU005  drift of the worst-case ulp bound (costmodel.
         reassociation_ulp_bound: (participants - 1) per float
         all_reduce the Layout logs, at ULP_AXIS_SIZES) against the
         port's baseline, analysis/baselines/graftnum.json. A one-rank
         round reduces nothing across ranks and prices 0; the bound of
         the rank world comes from graftmesh's two layouts (analysis/
         shardaudit.run_worlds), programs `base/<stage>@<layout>`.

The lattice is the JAX tier's, per value: {finite, nonneg, nonzero,
mask}. A round input is assumed finite; `where` is the sanctioned guard
unless a branch is a non-finite constant (an injection site).

CLI: ``python -m commefficient_tpu_torch.analysis.numaudit``; exit codes
0 clean, 1 violations, 2 drift only, 3 usage; the report is canonical
JSON, bit-identical across runs, journaled as `num_audit_digest`.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
from typing import Dict, List, Optional, Tuple

from commefficient_tpu_torch.analysis.audit import (
    AUDIT_GEOMETRY, AUDIT_POPULATION, STATE_MOTION_PROGRAMS, AuditBaseline,
    AuditFinding, audit_configs, canonical_digest, common_args, finish,
    program_records, program_variants_for, record_round,
)
from commefficient_tpu_torch.analysis.costmodel import (
    _ITEMSIZE, base_op, reassociation_ulp_bound,
)
from commefficient_tpu_torch.analysis.domains import precision_seam_pairs

NUM_RULE_DOCS = {
    "NU001": "NaN-unsafe mask arithmetic: possibly-non-finite value "
             "multiplied by a 0/1 mask (NaN*0 == NaN; use torch.where)",
    "NU002": "unregistered precision downcast (not in analysis/"
             "domains.PRECISION_SEAMS), or a sub-f32 error-feedback "
             "residual operand",
    "NU003": "unguarded division/reciprocal/rsqrt/log/sqrt: argument "
             "not provably bounded away from zero (or non-negative, for "
             "sqrt) through the lattice",
    "NU004": "replay-nondeterministic op on the card (float atomics "
             "of index_add / scatter_add / accumulate, conv backward; "
             "an unstable sort or topk whose indices are read)",
    "NU005": "worst-case ulp-bound drift vs analysis/baselines/"
             "graftnum.json (new / stale / moved program)",
}

# the participant counts the ulp bound prices at (the JAX package's:
# the declared deployment axes, not the world that ran)
ULP_AXIS_SIZES = {"clients": 8, "model": 2}

# the span program's rounds (the JAX package's)
SPAN_LEN = 2

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baselines", "graftnum.json")


class NumBaseline(AuditBaseline):
    COST_KEY = "ulp"
    COST_FIELDS = ("worst_case_ulp",)
    DRIFT_RULE = "NU005"


# ---------------------------------------------------------------------------
# the lattice


@dataclasses.dataclass(frozen=True)
class Absval:
    """What the lattice proves of one value (False: not proven)."""
    finite: bool = True
    nonneg: bool = False
    nonzero: bool = False
    mask: bool = False
    const_nonfinite: bool = False
    src: str = ""
    nonpos: bool = False


_DEFAULT = Absval()
_MASK = Absval(finite=True, nonneg=True, mask=True)
_ZEROS = _MASK
_ONES = Absval(finite=True, nonneg=True, nonzero=True, mask=True)


def const_absval(v) -> Absval:
    if isinstance(v, bool):
        return Absval(finite=True, nonneg=True, nonzero=v, mask=True)
    if not isinstance(v, (int, float)):
        return _DEFAULT
    fin = math.isfinite(v)
    return Absval(finite=fin, nonneg=fin and v >= 0,
                  nonzero=fin and v != 0, mask=fin and v in (0, 1),
                  const_nonfinite=not fin,
                  src="" if fin else f"a non-finite constant ({v})",
                  nonpos=fin and v <= 0)


def _join(vals) -> Absval:
    vals = list(vals)
    if not vals:
        return _DEFAULT
    return Absval(finite=all(v.finite for v in vals),
                  nonneg=all(v.nonneg for v in vals),
                  nonzero=all(v.nonzero for v in vals),
                  mask=all(v.mask for v in vals),
                  const_nonfinite=any(v.const_nonfinite for v in vals),
                  src=next((v.src for v in vals if v.src), ""))


_MASK_OPS = frozenset({
    "eq", "ne", "lt", "le", "gt", "ge", "isfinite", "isnan", "isinf",
    "logical_and", "logical_or", "logical_not", "logical_xor", "any",
    "all", "isneginf", "isposinf",
})
_PASS_OPS = frozenset({
    "view", "_unsafe_view", "_reshape_alias", "reshape", "expand",
    "permute", "transpose", "t", "squeeze", "unsqueeze", "slice",
    "select", "alias", "detach", "as_strided", "narrow", "split",
    "unbind", "clone", "contiguous", "_to_copy", "index", "gather",
    "index_select", "flip", "roll", "repeat", "lift_fresh", "diagonal",
    "constant_pad_nd", "tril", "triu", "copy",
})
_JOIN_OPS = frozenset({"cat", "stack"})
_CONST_OPS = frozenset({"full", "full_like", "new_full", "scalar_tensor",
                        "fill"})
_ZERO_OPS = frozenset({"zeros", "zeros_like", "new_zeros", "zero",
                       "empty", "empty_like", "new_empty",
                       "empty_strided"})
_ONE_OPS = frozenset({"ones", "ones_like", "new_ones"})
_KEEP_SIGN_REDUCERS = frozenset({"sum", "mean", "amax", "amin", "max",
                                 "min", "prod", "cumsum", "median",
                                 "nanmedian", "sort", "topk"})
_NONNEG_OPS = frozenset({"abs", "linalg_vector_norm", "norm", "var", "std",
                         "exp", "square", "relu", "sigmoid", "softmax",
                         "_softmax", "count_nonzero", "popcount"})


def _numeric(scalars) -> list:
    return [s for s in scalars if isinstance(s, (int, float))
            and not isinstance(s, bool)]


# round inputs declared {0, 1} (RoundBatch's validity mask and fault
# masks): indicators, as the JAX lattice reads a comparison's result
MASK_INPUTS = frozenset({"batch.mask", "batch.survivors", "batch.poison"})


class _Lattice:
    """One program's NU001 / NU003 walk over its records."""

    def __init__(self, program: str, names: Dict[int, str]):
        self.program = program
        self.env: Dict[int, Absval] = {}
        self.names = names
        self.neg_of: Dict[int, int] = {}
        self.findings: List[AuditFinding] = []

    def read(self, vid: int, meta) -> Absval:
        got = self.env.get(vid)
        if got is not None:
            return got
        if meta[1] == "bool" or self.names.get(vid) in MASK_INPUTS:
            return _MASK
        return Absval(finite=True)

    def operands(self, rec) -> List[Absval]:
        """The op's operands in order: its tensors, then its numeric
        scalars (a scalar rides after the tensors in every op walked
        here)."""
        vals = [self.read(v, m) for v, m in zip(rec.in_vids, rec.ins)]
        return vals + [const_absval(s) for s in _numeric(rec.scalars)]

    def find(self, rule: str, msg: str) -> None:
        self.findings.append(AuditFinding(self.program, rule, msg))

    def step(self, rec) -> None:
        if rec.kernel is not None:
            return
        op = base_op(rec.op)
        core = op[:-1] if op.endswith("_") and op[:-1] else op
        ops = self.operands(rec)
        out = self.transfer(rec, core, ops)
        if core == "neg" and rec.in_vids and rec.out_vids:
            self.neg_of[rec.out_vids[0]] = rec.in_vids[0]
        for vid, m in zip(rec.out_vids, rec.outs):
            if m[1] == "bool":
                self.env[vid] = _MASK
            elif m[1].startswith(("int", "uint")):
                self.env[vid] = Absval(finite=True, nonneg=out.nonneg,
                                       nonzero=out.nonzero, mask=out.mask)
            else:
                self.env[vid] = out

    def transfer(self, rec, op: str, ops: List[Absval]) -> Absval:
        fin = all(v.finite for v in ops)
        src = next((v.src for v in ops if v.src), "")
        if op in _MASK_OPS:
            return _MASK
        if op in _ZERO_OPS:
            return _ZEROS
        if op in _ONE_OPS:
            return _ONES
        if op in _CONST_OPS:
            nums = _numeric(rec.scalars)
            return const_absval(nums[-1]) if nums else _DEFAULT
        if op in _PASS_OPS:
            return ops[0] if ops else _DEFAULT
        if op in _JOIN_OPS:
            return _join(ops)
        if op == "where":
            branches = ops[1:3]
            bad = next((b for b in branches if b.const_nonfinite), None)
            if bad is not None:
                return Absval(finite=False, src=bad.src or
                              "a where() injecting a non-finite constant")
            return Absval(finite=True,
                          nonneg=all(b.nonneg for b in branches),
                          nonzero=all(b.nonzero for b in branches),
                          mask=all(b.mask for b in branches))
        if op == "mul" and len(ops) >= 2:
            a, b = ops[0], ops[1]
            for m, x in ((a, b), (b, a)):
                if m.mask and not x.finite:
                    origin = x.src or "an unproven op"
                    self.find("NU001",
                              f"`{rec.op}` multiplies a possibly "
                              f"non-finite value (from {origin}) by a 0/1 "
                              "mask: NaN * 0 is NaN, so the masked-out "
                              "lanes are poisoned; select with "
                              "torch.where instead")
                    break
            v = rec.in_vids
            same = len(v) == 2 and v[0] == v[1]
            # -x * x: a negated square
            negsq = len(v) == 2 and (self.neg_of.get(v[0]) == v[1]
                                     or self.neg_of.get(v[1]) == v[0])
            return Absval(finite=fin, nonneg=(a.nonneg and b.nonneg) or same
                          or (a.nonpos and b.nonpos),
                          nonpos=negsq or (a.nonneg and b.nonpos)
                          or (a.nonpos and b.nonneg),
                          nonzero=a.nonzero and b.nonzero,
                          mask=a.mask and b.mask, src=src)
        if op == "div" and len(ops) >= 2:
            num, den = ops[0], ops[1]
            if not den.nonzero:
                shape = rec.ins[1][0] if len(rec.ins) > 1 else ()
                self.find("NU003",
                          f"`{rec.op}` divides by a value not proven away "
                          f"from zero (shape {shape}): clamp it (min > "
                          "0), add an epsilon, or guard with where")
            return Absval(finite=num.finite and den.nonzero,
                          nonneg=num.nonneg and den.nonneg,
                          nonzero=num.nonzero and den.finite,
                          src=src or ("" if den.nonzero else
                                      "an unguarded division"))
        if op in ("reciprocal", "rsqrt", "log", "log2", "log10"):
            a = ops[0]
            if not a.nonzero:
                self.find("NU003",
                          f"`{rec.op}` of a value not proven away from "
                          "zero: clamp it (min > 0) or add an epsilon")
            return Absval(finite=a.finite and a.nonzero,
                          nonneg=op in ("reciprocal", "rsqrt") and a.nonneg,
                          nonzero=op in ("reciprocal", "rsqrt"),
                          src=src or ("" if a.nonzero else
                                      f"an unguarded {op}"))
        if op == "sqrt":
            a = ops[0]
            if not a.nonneg:
                self.find("NU003",
                          f"`{rec.op}` of a value not proven non-negative")
            return Absval(finite=a.finite, nonneg=True,
                          nonzero=a.nonzero and a.nonneg, src=src)
        if op in ("clamp", "clamp_min"):
            lo = rec.kwarg("min")
            if lo is None:
                nums = _numeric(rec.scalars)
                lo = nums[0] if nums else None
            pos = isinstance(lo, (int, float)) and lo > 0
            a = ops[0]
            return Absval(finite=a.finite, nonneg=a.nonneg or (
                lo is not None and lo >= 0), nonzero=pos or a.nonzero,
                src=a.src)
        if op == "maximum" and len(ops) >= 2:
            a, b = ops[0], ops[1]
            return Absval(finite=fin, nonneg=a.nonneg or b.nonneg,
                          nonzero=(a.nonzero and a.nonneg)
                          or (b.nonzero and b.nonneg), src=src)
        if op == "add" and len(ops) >= 2:
            a, b = ops[0], ops[1]
            nonneg = a.nonneg and b.nonneg
            return Absval(finite=fin, nonneg=nonneg,
                          nonzero=nonneg and (a.nonzero or b.nonzero),
                          src=src)
        if op == "pow" and ops:
            nums = _numeric(rec.scalars)
            even = bool(nums) and float(nums[0]) % 2 == 0
            return Absval(finite=fin, nonneg=even or ops[0].nonneg,
                          src=src)
        if op in _NONNEG_OPS:
            return Absval(finite=fin, nonneg=True, src=src)
        if op == "neg" and ops:
            a = ops[0]
            return Absval(finite=a.finite, nonneg=a.nonpos, nonpos=a.nonneg,
                          nonzero=a.nonzero, src=a.src)
        if op == "log1p" and ops:
            # log1p(y) has y's sign (for y > -1, NaN otherwise)
            a = ops[0]
            return Absval(finite=False, nonneg=a.nonneg, nonpos=a.nonpos,
                          src=a.src or "log1p")
        if op in _KEEP_SIGN_REDUCERS:
            a = ops[0] if ops else _DEFAULT
            return Absval(finite=a.finite, nonneg=a.nonneg, src=a.src)
        return Absval(finite=fin, src=src)


def lattice_findings(program: str, records, names=None
                     ) -> List[AuditFinding]:
    """NU001 + NU003 over one program's records (`names`: the recorder's
    round-input names, for the declared masks)."""
    walk = _Lattice(program, names or {})
    for rec in records:
        walk.step(rec)
    return sorted(walk.findings)


# ---------------------------------------------------------------------------
# NU002: precision seams and the error-feedback width


def _is_float(dt: str) -> bool:
    return dt.startswith(("float", "bfloat"))


def is_downcast(src: str, dst: str) -> bool:
    """A lossy conversion: float narrowing, or float -> int8/int16
    (float -> int32/int64 is an index or count, exact)."""
    if _is_float(src) and _is_float(dst):
        return _ITEMSIZE.get(dst, 4) < _ITEMSIZE.get(src, 4)
    if _is_float(src) and dst.startswith(("int", "uint")):
        return _ITEMSIZE.get(dst, 4) <= 2
    return False


def precision_findings(program: str, records, names: Dict[int, str]
                       ) -> List[AuditFinding]:
    seams = precision_seam_pairs()
    out: List[AuditFinding] = []
    for rec in records:
        if rec.kernel is not None:
            continue
        op = base_op(rec.op)
        if op == "_to_copy" and rec.ins and rec.outs:
            src, dst = rec.ins[0][1], rec.outs[0][1]
        elif op == "copy_" and len(rec.ins) >= 2:
            src, dst = rec.ins[1][1], rec.ins[0][1]
        else:
            continue
        if is_downcast(src, dst) and (src, dst) not in seams:
            out.append(AuditFinding(
                program, "NU002",
                f"unregistered precision downcast {src}->{dst} over "
                f"{rec.ins[0][0]}: every lossy seam must be declared in "
                "analysis/domains.PRECISION_SEAMS with its residual "
                "story before it ships"))
    seen = set()
    for rec in records:
        for vid, m in zip(rec.in_vids, rec.ins):
            name = names.get(vid)
            if (name is None or vid in seen or "err" not in name.lower()
                    or not _is_float(m[1])):
                continue
            seen.add(vid)
            if _ITEMSIZE.get(m[1], 4) < 4:
                out.append(AuditFinding(
                    program, "NU002",
                    f"error-feedback residual `{name}` is {m[1]}: the "
                    "residual accumulation must stay f32-or-wider end to "
                    "end"))
    return sorted(out)


# ---------------------------------------------------------------------------
# NU004: replay determinism on the card

# ops whose CUDA kernels add floats in an order the hardware picks
# (torch.use_deterministic_algorithms' lists); index_put / put only with
# accumulate
_CUDA_NONDETERMINISTIC = frozenset({
    "index_add", "scatter_add", "scatter_reduce", "cumsum",
    "embedding_dense_backward", "_embedding_bag_backward",
    "_embedding_bag_dense_backward", "convolution_backward",
    "max_pool3d_with_indices_backward", "avg_pool3d_backward",
    "_adaptive_avg_pool2d_backward", "_adaptive_avg_pool3d_backward",
    "adaptive_max_pool2d_backward", "upsample_bilinear2d_backward",
    "upsample_linear1d_backward", "upsample_bicubic2d_backward",
    "upsample_trilinear3d_backward", "grid_sampler_2d_backward",
    "nll_loss_forward", "nll_loss2d_forward", "histc", "bincount",
    "reflection_pad1d_backward", "reflection_pad2d_backward",
    "replication_pad1d_backward", "replication_pad2d_backward",
})
_ACCUMULATE = frozenset({"index_put", "_index_put_impl", "put"})


def nondeterministic_op(rec, deterministic: bool = False) -> Optional[str]:
    """Why `rec` may differ bitwise between two runs on the card, or
    None (only float work reorders)."""
    if deterministic or rec.kernel is not None:
        return None
    op = base_op(rec.op)
    core = op[:-1] if op.endswith("_") else op
    floats = any(_is_float(m[1]) for m in rec.outs) or any(
        _is_float(m[1]) for m in rec.ins)
    if core in _CUDA_NONDETERMINISTIC and floats:
        if core == "scatter_reduce" and rec.kwarg(
                "reduce", None) not in (None, "sum", "mean"):
            return None
        if core == "scatter_add" and len(rec.ins) > 1:
            # one index along `dim` a row (a gather's backward): no cell
            # takes two adds, so the order cannot matter
            dim = next((s for s in rec.scalars if isinstance(s, int)
                        and not isinstance(s, bool)), 0)
            idx = rec.ins[1][0]
            if idx and idx[dim % len(idx)] == 1:
                return None
        return f"`{rec.op}` orders its float atomics freely on CUDA"
    if core in _ACCUMULATE and floats and (
            rec.kwarg("accumulate") or True in [s for s in rec.scalars
                                                if isinstance(s, bool)]):
        return f"`{rec.op}` with accumulate adds in atomic order on CUDA"
    return None


# the operand each accumulating op sums: a 0/1 mask sums exactly in any
# order (integers below 2^24), so such a sum replays bitwise
_SUMMED = {"index_add": 2, "scatter_add": 2, "cumsum": 0, "index_put": -1,
           "_index_put_impl": -1, "scatter_reduce": 2}


def determinism_findings(program: str, records, deterministic: bool = False,
                         names=None) -> List[AuditFinding]:
    """NU004 over one program's records."""
    out: List[AuditFinding] = []
    read = set()
    for rec in records:
        read.update(rec.in_vids)
    walk = _Lattice(program, names or {})
    for rec in records:
        why = nondeterministic_op(rec, deterministic)
        op = base_op(rec.op).rstrip("_") or base_op(rec.op)
        pos = _SUMMED.get(op)
        if why is not None and pos is not None and len(rec.ins) > abs(pos):
            summed = walk.read(rec.in_vids[pos], rec.ins[pos])
            if summed.mask:
                why = None
        walk.step(rec)
        if why is not None:
            out.append(AuditFinding(
                program, "NU004",
                f"{why}: a resumed replay may differ in the last bits "
                "(enable torch.use_deterministic_algorithms, or take a "
                "sorted segment sum)"))
            continue
        op = base_op(rec.op)
        if op in ("sort", "topk") and len(rec.out_vids) > 1 \
                and rec.out_vids[1] in read:
            stable = rec.kwarg("stable")
            if op == "topk" or not stable:
                out.append(AuditFinding(
                    program, "NU004",
                    f"`{rec.op}`, {'a topk' if op == 'topk' else 'an unstable sort'}"
                    " whose indices the round reads: tie order is unspecified "
                    "and estimates tie often — take the indices from "
                    "ops/flat.topk_indices (a stable sort)"))
    return sorted(out)


# ---------------------------------------------------------------------------
# the full audit


def audit_records(prog: str, records, rec) -> List[AuditFinding]:
    return (lattice_findings(prog, records, rec.names)
            + precision_findings(prog, records, rec.names)
            + determinism_findings(prog, records, names=rec.names))


def run_num_audit(device: str = "cpu", worlds: Optional[dict] = None
                  ) -> Tuple[dict, List[AuditFinding]]:
    """Every audit config's programs, and the rank worlds' ulp bounds;
    returns (report, findings). NU005 is the caller's baseline diff."""
    from commefficient_tpu_torch.analysis import shardaudit
    by_program: Dict[str, Dict[str, int]] = {}
    ulp: Dict[str, Dict[str, int]] = {}
    findings: List[AuditFinding] = []

    def audit_one(prog, records, rec, log=()):
        fs = audit_records(prog, records, rec)
        findings.extend(fs)
        counts: Dict[str, int] = {}
        for f in fs:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        if counts:
            by_program[prog] = dict(sorted(counts.items()))
        ulp[prog] = {"worst_case_ulp": reassociation_ulp_bound(
            log, ULP_AXIS_SIZES)}

    for cfg_name, cfg in audit_configs():
        variants = program_variants_for(cfg)
        for i, variant in enumerate(variants):
            rec = record_round(cfg, variant, device)
            for name in (variant,) + (STATE_MOTION_PROGRAMS if i == 0
                                      else ()):
                audit_one(f"{cfg_name}/{name}", program_records(rec, name),
                          rec)
        rec = record_round(cfg, variants[0], device, rounds=SPAN_LEN)
        audit_one(f"{cfg_name}/span", rec.records, rec)
    worlds = worlds if worlds is not None else shardaudit.run_worlds()
    for name in sorted(worlds):
        doc = min(worlds[name], key=lambda d: d["rank"])
        for prog, log in shardaudit.program_logs(doc).items():
            ulp[f"base/{prog}@{name}"] = {
                "worst_case_ulp": reassociation_ulp_bound(
                    log, ULP_AXIS_SIZES)}
    rules = {r: 0 for r in NUM_RULE_DOCS}
    for f in findings:
        rules[f.rule] = rules.get(f.rule, 0) + 1
    report = {
        "version": 1,
        "geometry": dict(AUDIT_GEOMETRY, population=AUDIT_POPULATION,
                         span_len=SPAN_LEN, ulp_axes=dict(ULP_AXIS_SIZES)),
        "rules": rules,
        "by_program": dict(sorted(by_program.items())),
        "ulp": {p: ulp[p] for p in sorted(ulp)},
        "registry": {"precision_seams": len(precision_seam_pairs())},
    }
    report["digest"] = canonical_digest(
        {k: report[k] for k in ("geometry", "rules", "by_program", "ulp",
                                "registry")})
    return report, sorted(findings)


def journal_digest(journal_path: str, report: dict,
                   findings_count: int) -> dict:
    """Append the report as a `num_audit_digest` journal event."""
    from commefficient_tpu_torch.telemetry.journal import append_event
    return append_event(journal_path, "num_audit_digest",
                        digest=report["digest"], rules=report["rules"],
                        ulp={p: d["worst_case_ulp"]
                             for p, d in report["ulp"].items()},
                        findings=int(findings_count))


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftnum",
        description="recorded-round numerics & determinism auditor: "
                    "NaN-unsafe masks, precision seams, zero guards, "
                    "replay determinism, the ulp baseline (rules "
                    "NU001-NU005). Exit codes: 0 clean, 1 violations, 2 "
                    "drift only.")
    common_args(ap, DEFAULT_BASELINE)
    ap.add_argument("--device", default="cpu",
                    help="the device the rounds run on (cpu, cuda)")
    args = ap.parse_args(argv)
    if args.list_rules:
        for code, doc in sorted(NUM_RULE_DOCS.items()):
            print(f"{code}  {doc}")
        return 0
    if args.device not in ("cpu", "cuda"):
        print(f"graftnum: unknown device {args.device!r}", file=sys.stderr)
        return 3
    report, findings = run_num_audit(args.device)
    return finish("graftnum", args, report, findings, NumBaseline, "ulp",
                  journal_digest)


if __name__ == "__main__":
    sys.exit(main())
