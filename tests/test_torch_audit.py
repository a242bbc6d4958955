"""graftaudit, the cost model and the rules over the round's path
(commefficient_tpu_torch/analysis/audit.py, costmodel.py, rules.py)
against the JAX package's tiers: the tables and constants, every JAX
rule code ported (with a firing case) or named under ROADMAP.md's "Not
to port", the seeded defects firing the same codes in both packages,
the matmul and convolution FLOPs of a ResNet9 and a GPT2 equal to
`jaxpr_cost`, and the CLI clean, bit-identical and journaled.

The JAX round programs do not trace in this container (shard_map's vma
check), so the JAX side runs its finding functions on small jaxprs made
here; the port records the same ops with its RoundRecorder."""
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from commefficient_tpu.analysis import audit as jaudit
from commefficient_tpu.analysis import costmodel as jcost
from commefficient_tpu.analysis import domains as jdomains
from commefficient_tpu.analysis import numaudit as jnum
from commefficient_tpu.analysis import rules as jrules
from commefficient_tpu.analysis import shardaudit as jshard
from commefficient_tpu.config import Config as JConfig
from commefficient_tpu.models import gpt2 as JG
from commefficient_tpu.models.resnet9 import ResNet9 as JResNet9
from commefficient_tpu.telemetry.journal import (
    validate_journal as j_validate_journal,
)
from commefficient_tpu.training.cv_train import (
    make_compute_loss as j_make_compute_loss,
)
from commefficient_tpu.training.gpt2_train import (
    make_compute_loss_train as j_make_gpt2_loss,
)
from commefficient_tpu_torch.analysis import audit, costmodel, domains
from commefficient_tpu_torch.analysis import numaudit, rules, shardaudit
from commefficient_tpu_torch.analysis.engine import lint_source
from commefficient_tpu_torch.analysis.recorder import RoundRecorder, stage
from commefficient_tpu_torch.config import Config as TConfig
from commefficient_tpu_torch.federated.client import make_flat_loss_fn
from commefficient_tpu_torch.models import build_model
from commefficient_tpu_torch.models import gpt2 as TG
from commefficient_tpu_torch.models.convert import from_jax_params
from commefficient_tpu_torch.ops.flat import flatten_params
from commefficient_tpu_torch.parallel import mesh as tmesh
from commefficient_tpu_torch.telemetry.journal import validate_journal
from commefficient_tpu_torch.training.cv_train import (
    make_compute_loss as t_make_compute_loss,
)
from commefficient_tpu_torch.training.gpt2_train import (
    make_compute_loss_train as t_make_gpt2_loss,
)

pytestmark = pytest.mark.torch_port

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_CODES = (set(rules.ALL_RULES) | set(audit.AUDIT_RULE_DOCS)
              | set(shardaudit.MESH_RULE_DOCS) | set(numaudit.NUM_RULE_DOCS))
JAX_CODES = (set(jrules.ALL_RULES) | set(jaudit.AUDIT_RULE_DOCS)
             | set(jshard.MESH_RULE_DOCS) | set(jnum.NUM_RULE_DOCS))


def test_tables_and_constants_are_the_jax_packages():
    assert audit.TOPK_MIN_K == jaudit.TOPK_MIN_K == rules.GL008_MIN_K
    assert audit.SORT_MIN_N == jaudit.SORT_MIN_N
    assert audit.AUDIT_POPULATION == jaudit.AUDIT_POPULATION
    assert audit.AUDIT_GEOMETRY == jaudit.AUDIT_GEOMETRY
    assert audit.TIER_WORKING_SET == jaudit.TIER_WORKING_SET
    assert shardaudit.MESH_POPULATION == jshard.MESH_POPULATION
    assert shardaudit.SPAN_LEN == jshard.SPAN_LEN == numaudit.SPAN_LEN \
        == jnum.SPAN_LEN
    assert numaudit.ULP_AXIS_SIZES == jnum.ULP_AXIS_SIZES
    assert domains.MESH_AXES == jdomains.MESH_AXES == (
        tmesh.CLIENTS_AXIS, tmesh.MODEL_AXIS)
    assert domains.precision_seam_pairs() == jdomains.precision_seam_pairs()
    assert set(domains.PRECISION_SEAMS) == set(jdomains.PRECISION_SEAMS)
    assert set(audit.AUDIT_RULE_DOCS) == set(jaudit.AUDIT_RULE_DOCS)
    assert set(numaudit.NUM_RULE_DOCS) == set(jnum.NUM_RULE_DOCS)
    assert set(rules.ALL_RULES) == set(jrules.ALL_RULES)
    assert set(rules.HOST_RULES) | set(rules.TRACED_RULES) == set(
        rules.ALL_RULES)
    assert audit.PROGRAM_VARIANTS == ("mask_free", "dropout",
                                      "dropout_stragglers")
    assert [n for n, _ in audit.audit_configs()] == [
        n.replace("sketch-xla", "sketch-cuda") for n, _ in
        jaudit.audit_configs(backends=("xla",))]


def _not_to_port_codes() -> set:
    """The rule codes ROADMAP.md's "Not to port" lines name in bold."""
    with open(os.path.join(REPO, "ROADMAP.md"), encoding="utf-8") as f:
        text = f.read()
    section = text.split("Not to port, each for a stated reason:")[1]
    section = section.split("### Queue 2")[0]
    return set(re.findall(r"\*\*((?:GL|AU|NU)\d{3})\*\*", section))


def test_every_jax_code_is_ported_or_not_to_port():
    assert len(JAX_CODES) == 30
    assert JAX_CODES - PORT_CODES == _not_to_port_codes() == {"AU009",
                                                              "AU011"}
    assert PORT_CODES <= JAX_CODES
    assert set(FIRING) == PORT_CODES


# ---------------- a firing case for every port code ---------------------

ROUND = "commefficient_tpu_torch/ops/x.py"
FED = "commefficient_tpu_torch/federated/x.py"
GL_CASES = {
    "GL001": (ROUND, "import time\ndef f():\n    return time.time()\n", 3),
    "GL002": (ROUND, "def f(x):\n    return x.item()\n", 2),
    "GL003": (ROUND, "from commefficient_tpu_torch.ops.prng import normal\n"
              "def f(key):\n    a = normal(key, (2,))\n"
              "    b = normal(key, (2,))\n    return a + b\n", 4),
    "GL004": (ROUND, "def f(x):\n    if x.sum() > 0:\n        return x\n",
              2),
    "GL005": ("pkg/a.py", "try:\n    f()\nexcept Exception:\n    pass\n",
              3),
    "GL006": ("pkg/a.py", "def w(p):\n    with open(p, 'w') as f:\n"
              "        f.write('x')\n", 2),
    "GL007": (FED, "import torch.distributed as dist\ndef f(t):\n"
              "    dist.all_reduce(t)\n", 3),
    "GL008": (ROUND, "import torch\ndef f(x):\n"
              "    return torch.topk(x, 4096)\n", 3),
    "GL009": ("pkg/a.py", "import numpy as np\n"
              "r = np.random.SeedSequence([1, 0xBEEF, 2])\n", 2),
    "GL010": (FED, "def f(layout, t):\n"
              "    return layout.all_reduce(t, axis='clientz')\n", 2),
    "GL011": ("pkg/a.py", "import time\nt0 = time.time()\n"
              "dt = time.time() - t0\n", 3),
    "GL012": ("pkg/a.py", "import threading\n"
              "t = threading.Thread(target=print)\n", 2),
    "GL013": (ROUND, "def f(x):\n    return x == 0.5\n", 2),
    "GL014": ("pkg/a.py", "class C:\n    WIRE_FIELD = 'rogue_field'\n",
              2),
}
# the rules over the round's path, their clean twin (the idiom the rule
# sanctions, or the same source off the round's path)
GL_CLEAN = {
    "GL001": ("pkg/a.py", GL_CASES["GL001"][1]),
    "GL002": (ROUND, "def f(x):\n    return x.sum()\n"),
    "GL003": (ROUND, "from commefficient_tpu_torch.ops.prng import "
              "fold_in, normal\ndef f(key):\n    a = normal(key, (2,))\n"
              "    key = fold_in(key, 1)\n    b = normal(key, (2,))\n"
              "    return a + b\n"),
    "GL004": (ROUND, "import torch\ndef f(x):\n"
              "    return torch.where(x.sum() > 0, x, -x)\n"),
    "GL007": ("commefficient_tpu_torch/parallel/mesh.py",
              GL_CASES["GL007"][1]),
    "GL008": (ROUND, "from commefficient_tpu_torch.ops.flat import "
              "topk_indices\ndef f(x):\n    return topk_indices(x, 4096)\n"),
    "GL010": (FED, "def f(layout, t):\n"
              "    return layout.all_reduce(t, axis='clients')\n"),
    "GL013": (ROUND, "def f(x):\n    return x == 0.0\n"),
}


def _recorded(fn, stage_name="round"):
    with RoundRecorder() as rec:
        with stage(stage_name):
            fn()
    return rec


def _rules_of(findings) -> set:
    return {f.rule for f in findings}


def _port_fires(code) -> set:
    x = torch.rand(8)
    if code in GL_CASES:
        path, src, line = GL_CASES[code]
        hits = lint_source(path, src)
        assert [v.line for v in hits if v.rule == code] == [line], hits
        return {v.rule for v in hits}
    if code in ("AU001", "AU002", "AU003"):
        fn = {"AU001": lambda: x.sum().item(),
              "AU002": lambda: (x.double() * 2).sum(),
              "AU003": lambda: torch.sort(torch.rand(1 << 16))}[code]
        return _rules_of(audit.forbidden_op_findings(
            "p", _recorded(fn).records))
    if code == "AU004":
        rec = _recorded(lambda: (torch.zeros(23, 4) + x[:4]).sum(0))
        return _rules_of(audit.population_scan("p", rec.records, 23, {},
                                               strict=True)[1])
    if code == "AU005":
        block = torch.rand(23, 4)
        rec = _recorded(lambda: block.clone(), "scatter")
        return _rules_of(audit.population_scan("p", rec.records, 23, {})[1])
    if code == "AU006":
        return _rules_of(audit.AuditBaseline().apply_costs(
            {"p": {"flops": 1, "hbm_bytes": 1}}, 0.0))
    if code == "AU007":
        return _rules_of(shardaudit.replication_findings("p", {
            "rank": 0, "rows": {"errors": [184, 4]}, "local_rows": 92}))
    if code in ("AU008", "AU010"):
        link = shardaudit.link_model("multislice2")
        log = ([("all_reduce", "clients", (184, 4), "float32", "round")]
               if code == "AU008" else
               [("all_reduce", "clients", (64, 4), "float32", "round")] * 2)
        return _rules_of(shardaudit.collective_findings(
            "p", costmodel.collective_cost(log, link), 184, 1024, 1))
    if code == "NU001":
        rec = _recorded(lambda: torch.where(
            x > 0.5, torch.full_like(x, math.inf), x) * (x > 0.1))
        return _rules_of(numaudit.lattice_findings("p", rec.records))
    if code == "NU002":
        rec = _recorded(lambda: x.to(torch.bfloat16).to(torch.int8))
        return _rules_of(numaudit.precision_findings("p", rec.records, {}))
    if code == "NU003":
        y = torch.rand(8)
        rec = _recorded(lambda: x / y)
        return _rules_of(numaudit.lattice_findings("p", rec.records))
    if code == "NU004":
        def unstable():
            _, i = torch.sort(x, stable=False)
            return x[i]
        rec = _recorded(unstable)
        return _rules_of(numaudit.determinism_findings("p", rec.records))
    if code == "NU005":
        return _rules_of(numaudit.NumBaseline().apply_costs(
            {"p": {"worst_case_ulp": 7}}, 0.0))
    raise KeyError(code)


FIRING = sorted(set(GL_CASES) | {
    "AU001", "AU002", "AU003", "AU004", "AU005", "AU006", "AU007",
    "AU008", "AU010", "NU001", "NU002", "NU003", "NU004", "NU005"})


@pytest.mark.parametrize("code", FIRING)
def test_every_port_code_fires(code):
    assert code in _port_fires(code)


@pytest.mark.parametrize("code", sorted(GL_CLEAN))
def test_round_path_rules_stay_quiet_on_the_sanctioned_idiom(code):
    path, src = GL_CLEAN[code]
    assert [v for v in lint_source(path, src) if v.rule == code] == []


def test_round_path_suppression_takes_a_reason():
    path, src, line = GL_CASES["GL002"]
    lines = src.splitlines()
    lines[line - 1] += "  # graftlint: disable=GL002 -- host-side key"
    assert lint_source(path, "\n".join(lines) + "\n") == []


# ---------------- seeded defects: the same code in both packages --------

def _jax_findings(defect):
    f32 = np.ones(4, np.float32)
    if defect == "f64":
        with jax.enable_x64(True):
            closed = jax.make_jaxpr(
                lambda x: (x.astype(jnp.float64) * 2).sum())(f32)
        return jaudit.forbidden_primitive_findings("p", closed)
    if defect == "sort":
        return jaudit.forbidden_primitive_findings("p", jax.make_jaxpr(
            jnp.sort)(np.zeros(1 << 16, np.float32)))
    if defect == "population":
        closed = jax.make_jaxpr(
            lambda x: (jnp.broadcast_to(x, (23, 4)) * 2).sum(0))(f32)
        return jaudit.population_scan("p", closed, 23, ["x"], ["o"],
                                      strict=True)[1]
    if defect == "host_read":
        return jaudit.forbidden_primitive_findings("p", jax.make_jaxpr(
            lambda x: (jax.debug.callback(lambda v: None, x), x * 2)[1])(
                f32))
    if defect == "bf16_cast":
        closed = jax.make_jaxpr(
            lambda x: x.astype(jnp.bfloat16).astype(jnp.int8))(f32)
        return jnum.precision_findings("p", closed, ["x"], ["o"])
    if defect == "population_all_reduce":
        closed = jax.make_jaxpr(
            lambda x: jax.lax.psum(x, "clients"),
            axis_env=[("clients", 2)])(np.zeros((184, 4), np.float32))
        cost = jcost.collective_cost(closed, jcost.MeshLinkModel(
            "m", (("clients", 2),), (("clients", 1),)))
        return jshard.collective_findings("p", cost, 184, 1024, 1)
    raise KeyError(defect)


def _port_findings(defect):
    x = torch.ones(4)
    if defect == "f64":
        return audit.forbidden_op_findings("p", _recorded(
            lambda: (x.double() * 2).sum()).records)
    if defect == "sort":
        return audit.forbidden_op_findings("p", _recorded(
            lambda: torch.sort(torch.zeros(1 << 16))).records)
    if defect == "population":
        rec = _recorded(lambda: (x.expand(23, 4) * 2).sum(0))
        return audit.population_scan("p", rec.records, 23, {},
                                     strict=True)[1]
    if defect == "host_read":
        return audit.forbidden_op_findings("p", _recorded(
            lambda: (x * 2).sum().item()).records)
    if defect == "bf16_cast":
        return numaudit.precision_findings("p", _recorded(
            lambda: x.to(torch.bfloat16).to(torch.int8)).records, {})
    if defect == "population_all_reduce":
        return shardaudit.collective_findings(
            "p", costmodel.collective_cost(
                [("all_reduce", "clients", (184, 4), "float32", "round")],
                shardaudit.link_model("clients2")), 184, 1024, 1)
    raise KeyError(defect)


@pytest.mark.parametrize("defect,code", [
    ("f64", "AU002"), ("sort", "AU003"), ("population", "AU004"),
    ("host_read", "AU001"), ("bf16_cast", "NU002"),
    ("population_all_reduce", "AU008")])
def test_seeded_defects_fire_the_same_code_in_both(defect, code):
    assert _rules_of(_jax_findings(defect)) == {code}
    assert _rules_of(_port_findings(defect)) == {code}


# ---------------- cost parity: matmul and convolution FLOPs -------------

def _jax_class_flops(closed) -> dict:
    rows = jcost.jaxpr_cost(closed).by_primitive
    return {"matmul": rows.get("dot_general", {}).get("flops", 0),
            "conv": rows.get("conv_general_dilated", {}).get("flops", 0)}


def _port_class_flops(loss_fn, unravel, vec, batch, mask):
    w = vec.clone().requires_grad_(True)
    with RoundRecorder() as rec:
        loss, _ = make_flat_loss_fn(loss_fn, unravel)(w, batch, mask)
        torch.autograd.grad(loss, w)
    return costmodel.class_flops(rec.records), rec


def test_resnet9_fwd_bwd_flops_equal_jaxpr_cost():
    channels = {"prep": 4, "layer1": 8, "layer2": 8, "layer3": 16}
    jm = JResNet9(num_classes=10, channels=channels)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((2, 32, 32, 3), jnp.float32))
    tm = build_model("ResNet9", channels=channels)
    from_jax_params(tm, params)
    rng = np.random.RandomState(0)
    x = rng.randn(3, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, (3,)).astype(np.int32)
    mask = np.ones(3, np.float32)
    jloss = j_make_compute_loss(jm)
    vec, unravel = ravel_pytree(params)
    closed = jax.make_jaxpr(jax.grad(
        lambda v: jloss(unravel(v), (jnp.asarray(x), jnp.asarray(y)),
                        jnp.asarray(mask))[0]))(vec)
    want = _jax_class_flops(closed)
    tvec, tunravel = flatten_params(tm)
    got, rec = _port_class_flops(
        t_make_compute_loss(tm), tunravel,
        tvec, (torch.from_numpy(x), torch.from_numpy(y)),
        torch.from_numpy(mask))
    assert want["conv"] > 0 and got == want
    # every op priced once, the bytes positive and the report canonical
    cost = costmodel.records_cost(rec.records)
    assert cost.eqns == len(rec.records) and cost.hbm_bytes > 0


def test_gpt2_fwd_bwd_matmul_flops_equal_jaxpr_cost():
    vocab, L = 61, 16
    jcfg = JG.GPT2Config(vocab_size=vocab, n_positions=L, n_embd=32,
                         n_layer=2, n_head=2)
    jm = JG.GPT2DoubleHeads(jcfg)
    rng = np.random.RandomState(0)
    B, C = 2, 2
    ids = rng.randint(0, vocab, (B, C, L)).astype(np.int32)
    tt = rng.randint(0, vocab, (B, C, L)).astype(np.int32)
    mc = rng.randint(0, L, (B, C)).astype(np.int32)
    labels = np.where(rng.rand(B, C, L) < 0.3, -1,
                      rng.randint(0, vocab, (B, C, L))).astype(np.int32)
    mc_labels = rng.randint(0, C, (B,)).astype(np.int32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                     jnp.asarray(tt), jnp.asarray(mc))
    tm = TG.GPT2DoubleHeads(TG.GPT2Config(
        vocab_size=vocab, n_positions=L, n_embd=32, n_layer=2, n_head=2))
    from_jax_params(tm, params)
    batch = (ids, mc, labels, mc_labels, tt)
    mask = np.ones(B, np.float32)
    kw = dict(lm_coef=2.0, mc_coef=0.5)
    vec, unravel = ravel_pytree(params)
    jloss = j_make_gpt2_loss(jm, JConfig(**kw))
    closed = jax.make_jaxpr(jax.grad(
        lambda v: jloss(unravel(v), tuple(map(jnp.asarray, batch)),
                        jnp.asarray(mask))[0]))(vec)
    want = _jax_class_flops(closed)
    tvec, tunravel = flatten_params(tm)
    got, _ = _port_class_flops(
        t_make_gpt2_loss(tm, TConfig(**kw, device="cpu")), tunravel, tvec,
        tuple(map(torch.from_numpy, batch)), torch.from_numpy(mask))
    assert want["matmul"] > 0 and got == want


# ---------------- the CLI ---------------------------------------------

@pytest.fixture(scope="module")
def audited():
    """One whole audit run, shared by the CLI's cases."""
    return audit.run_audit()


def test_audit_cli_clean_bit_identical_and_journaled(tmp_path, capsys,
                                                     monkeypatch, audited):
    monkeypatch.chdir(tmp_path)
    jpath = str(tmp_path / "j.jsonl")
    assert audit.main(["--journal", jpath]) == 0      # a second run
    first = capsys.readouterr().out
    report, findings = audited
    assert findings == []
    assert f"digest {report['digest'][:12]}" in first
    assert "graftaudit: clean (33 program(s)" in first
    for validate in (validate_journal, j_validate_journal):
        recs, problems = validate(jpath)
        assert problems == [] and recs[-1]["event"] == "audit_digest"
        assert recs[-1]["digest"] == report["digest"]
    # the inventory names the client-state rows the state motion moves
    inv = report["programs"]["client-state/scatter"][
        "population_inventory"]["inputs"]
    assert [e["name"] for e in inv] == ["clients.errors",
                                       "clients.velocities",
                                       "clients.weights"]
    assert audit.main(["--list-rules"]) == 0
    assert capsys.readouterr().out.count("AU00") == 6
    assert audit.main(["--device", "tpu"]) == 3


def test_audit_drift_exits_2_and_violations_1(tmp_path, capsys,
                                              monkeypatch, audited):
    monkeypatch.setattr(audit, "run_audit", lambda device="cpu": audited)
    base = audit.AuditBaseline.load(audit.DEFAULT_BASELINE)
    prog = sorted(base.costs)[0]
    base.costs[prog] = {"flops": 1, "hbm_bytes": 1}
    path = str(tmp_path / "b.json")
    base.dump(path)
    assert audit.main(["--baseline", path]) == 2
    assert "AU006 static flops" in capsys.readouterr().out
    findings = audit.forbidden_op_findings("p", _recorded(
        lambda: torch.ones(2).sum().item()).records)
    violations, drift = audit.split_findings(findings, "AU006")
    assert audit.exit_code(violations, drift, []) == 1
