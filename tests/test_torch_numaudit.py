"""graftnum (commefficient_tpu_torch/analysis/numaudit.py) against the
JAX package's: NU001, NU003 and NU004 firing in both on the same
seeded defects, the lattice's sanctioned idioms quiet in both, the
audit configs clean against the port's baseline (its grandfathered
NU004 findings each with a reason), the report bit-identical across two
runs and its journal event valid under both packages' readers."""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commefficient_tpu.analysis import numaudit as jnum
from commefficient_tpu.telemetry.journal import (
    validate_journal as j_validate_journal,
)
from commefficient_tpu_torch.analysis import numaudit, shardaudit
from commefficient_tpu_torch.analysis.recorder import RoundRecorder, stage
from commefficient_tpu_torch.telemetry.journal import validate_journal

pytestmark = pytest.mark.torch_port

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

F = np.linspace(0.1, 0.9, 8).astype(np.float32)

# (JAX function, port function, the rule or None for a clean idiom),
# both of (x, m) with x, m in (0, 1)
CASES = {
    "nan_times_mask": (
        lambda x, m: jnp.where(x > 0.5, jnp.inf, x) * (m > 0.2),
        lambda x, m: torch.where(x > 0.5, torch.full_like(x, math.inf), x)
        * (m > 0.2), "NU001"),
    "nan_where_mask": (
        lambda x, m: jnp.where(m > 0.2, jnp.where(x > 0.5, jnp.inf, x), 0.0),
        lambda x, m: torch.where(m > 0.2, torch.where(
            x > 0.5, torch.full_like(x, math.inf), x), torch.zeros_like(x)),
        None),
    "raw_division": (lambda x, m: x / m, lambda x, m: x / m, "NU003"),
    "clamped_division": (
        lambda x, m: x / jnp.maximum(m.sum(), 1.0),
        lambda x, m: x / torch.clamp(m.sum(), min=1.0), None),
    "raw_rsqrt": (lambda x, m: jax.lax.rsqrt(x - m),
                  lambda x, m: torch.rsqrt(x - m), "NU003"),
    "sqrt_of_square": (lambda x, m: (lambda d: jnp.sqrt(d * d))(x - m),
                       lambda x, m: (lambda d: torch.sqrt(d * d))(x - m),
                       None),
    "sqrt_of_two_differences": (
        lambda x, m: jnp.sqrt((x - m) * (x - m)),
        lambda x, m: torch.sqrt((x - m) * (x - m)), "NU003"),
}


def _port_records(fn):
    x, m = torch.from_numpy(F), torch.from_numpy(F[::-1].copy())
    with RoundRecorder() as rec:
        with stage("round"):
            fn(x, m)
    return rec.records


@pytest.mark.parametrize("case", sorted(CASES))
def test_lattice_agrees_with_jax(case):
    jfn, tfn, rule = CASES[case]
    closed = jax.make_jaxpr(jfn)(F, F[::-1])
    want = {f.rule for f in jnum.lattice_findings("p", closed)}
    got = {f.rule for f in numaudit.lattice_findings("p",
                                                     _port_records(tfn))}
    assert want == got == ({rule} if rule else set())


def test_unstable_index_sort_fires_in_both_and_stable_sorts_do_not():
    closed = jax.make_jaxpr(lambda x: jnp.argsort(x, stable=False))(F)
    assert {f.rule for f in jnum.determinism_findings("p", closed)} == {
        "NU004"}
    x = torch.from_numpy(F)

    def unstable():
        _, i = torch.sort(x, stable=False)
        return x[i]

    def stable():
        _, i = torch.sort(x, stable=True)
        return x[i]

    def values_only():
        return torch.topk(x, 3).values.sum()

    assert {f.rule for f in numaudit.determinism_findings(
        "p", _port_records(lambda x, m: unstable()))} == {"NU004"}
    for fn in (stable, values_only):
        assert numaudit.determinism_findings(
            "p", _port_records(lambda x, m: fn())) == []
    closed = jax.make_jaxpr(lambda x: jnp.argsort(x, stable=True))(F)
    assert jnum.determinism_findings("p", closed) == []


def test_atomic_sums_fire_unless_they_add_a_mask():
    t = torch.zeros(8)
    idx = torch.tensor([0, 1, 1, 2])
    vals = torch.rand(4)
    recs = _port_records(lambda x, m: t.index_add(0, idx, vals))
    assert [f.rule for f in numaudit.determinism_findings("p", recs)] == [
        "NU004"]
    recs = _port_records(lambda x, m: torch.cumsum(x > 0.3, 0).float())
    assert numaudit.determinism_findings("p", recs) == []
    recs = _port_records(lambda x, m: t.index_add(0, idx, vals))
    assert numaudit.determinism_findings("p", recs, deterministic=True) == []


def test_error_feedback_residual_width():
    from commefficient_tpu_torch.analysis.recorder import RoundRecorder
    err = torch.zeros(4, dtype=torch.bfloat16)
    with RoundRecorder() as rec:
        rec.name_inputs("clients", {"errors": err})
        with stage("round"):
            err * 2
    got = numaudit.precision_findings("p", rec.records, rec.names)
    assert [f.rule for f in got] == ["NU002"] and "errors" in got[0].message


def test_num_audit_clean_bit_identical_and_journaled(tmp_path, capsys):
    worlds = shardaudit.run_worlds()
    jpath = str(tmp_path / "j.jsonl")
    report, findings = numaudit.run_num_audit(worlds=worlds)
    again, _ = numaudit.run_num_audit(worlds=worlds)
    assert report["digest"] == again["digest"]
    base = numaudit.NumBaseline.load(numaudit.DEFAULT_BASELINE)
    new, stale = base.apply_violations(findings)
    assert new == [] and stale == []
    assert base.apply_costs(report["ulp"], 0.0) == []
    # every grandfathered finding is the sparse re-sketch's atomics
    assert {r for _, r in base.violations} == {"NU004"}
    assert all("index_add_" in j for _, j in base.violations.values())
    assert all("index_add_" in f.message for f in findings)
    # the rank world's float all_reduces priced at the declared axes
    assert report["ulp"]["base/round@clients2"]["worst_case_ulp"] == 7
    numaudit.journal_digest(jpath, report, len(new))
    for validate in (validate_journal, j_validate_journal):
        recs, problems = validate(jpath)
        assert problems == [] and recs[-1]["event"] == "num_audit_digest"
    assert numaudit.main(["--list-rules"]) == 0
    assert capsys.readouterr().out.count("NU00") == 5
    assert numaudit.main(["--device", "tpu"]) == 3
    with open(numaudit.DEFAULT_BASELINE, encoding="utf-8") as f:
        assert json.load(f)["version"] == 1
