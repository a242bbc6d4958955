"""graftmesh (commefficient_tpu_torch/analysis/shardaudit.py): the
base scenario on 2-rank gloo worlds (one slice, and the --num_slices 2
emulation) clean against the port's per-link baseline, bit-identical
across two runs, journaled under both packages' readers; AU007, AU008
and AU010 fire on seeded layouts and collectives as the JAX package's
do; the link model prices as the JAX one."""
import os

import jax
import numpy as np
import pytest
import torch

from commefficient_tpu.analysis import costmodel as jcost
from commefficient_tpu.analysis import shardaudit as jshard
from commefficient_tpu.telemetry.journal import (
    validate_journal as j_validate_journal,
)
from commefficient_tpu_torch.analysis import costmodel, shardaudit
from commefficient_tpu_torch.telemetry.journal import validate_journal

pytestmark = pytest.mark.torch_port

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def test_mesh_audit_clean_bit_identical_and_journaled(tmp_path, capsys):
    jpath = str(tmp_path / "j.jsonl")
    assert shardaudit.main(["--journal", jpath]) == 0
    out = capsys.readouterr().out
    report, findings = shardaudit.run_mesh_audit()
    assert findings == [] and f"digest {report['digest'][:12]}" in out
    links = report["links"]
    # one table-sized all_reduce a round crosses slices, one for the
    # cohort's rows in the gather; the scatter moves by broadcasts
    assert links["base/round@clients2"]["dcn_bytes"] == 0
    ms = report["programs"]["base/round@multislice2"]
    assert ms["collectives"]["all_reduce"]["count"] == 1
    assert links["base/span@multislice2"]["dcn_collectives"] == 2 * (
        links["base/gather@multislice2"]["dcn_collectives"]
        + links["base/round@multislice2"]["dcn_collectives"]
        + links["base/scatter@multislice2"]["dcn_collectives"])
    for validate in (validate_journal, j_validate_journal):
        recs, problems = validate(jpath)
        assert problems == [] and recs[-1]["event"] == "mesh_audit_digest"
        assert recs[-1]["digest"] == report["digest"]


def test_seeded_layouts_fire_au007_au008_au010():
    rows = shardaudit.replication_findings("p", {
        "rank": 1, "rows": {"errors": [184, 4], "weights": [0]},
        "local_rows": 92})
    assert [f.rule for f in rows] == ["AU007"]
    assert shardaudit.replication_findings("p", {
        "rank": 1, "rows": {"errors": [92, 4]}, "local_rows": 92}) == []
    link = shardaudit.link_model("multislice2")
    pop = [("all_reduce", "clients", (184, 4), "float32", "round")]
    two = [("all_reduce", "clients", (64, 4), "float32", "round")] * 2
    model = [("all_reduce", "model", (4,), "float32", "round")]
    model_link = costmodel.MeshLinkModel(
        "m", (("clients", 2), ("model", 2)), (("clients", 1),
                                              ("model", 2)))

    def rules(log, lk=link):
        return [f.rule for f in shardaudit.collective_findings(
            "p", costmodel.collective_cost(log, lk), 184, 1024, 1)]

    assert rules(pop) == ["AU008"]
    assert rules(two) == ["AU010"]
    assert rules(two[:1]) == []
    assert rules(model, model_link) == ["AU010"]
    # two table reductions in two stages are one a stage each
    assert rules([two[0], ("all_reduce", "clients", (64, 4), "float32",
                           "gather")]) == []


def test_link_model_prices_as_the_jax_one():
    closed = jax.make_jaxpr(lambda x: jax.lax.psum(x, "clients"),
                            axis_env=[("clients", 2)])(
        np.zeros((16, 4), np.float32))
    for slices in (1, 2):
        jlink = jcost.MeshLinkModel("m", (("clients", 2),),
                                    (("clients", slices),))
        want = jcost.collective_cost(closed, jlink).as_dict()
        tlink = costmodel.MeshLinkModel("m", (("clients", 2),),
                                        (("clients", slices),))
        got = costmodel.collective_cost(
            [("all_reduce", "clients", (16, 4), "float32")], tlink).as_dict()
        assert {k: want[k] for k in ("ici_bytes", "dcn_bytes",
                                     "dcn_collectives")} == {
            k: got[k] for k in ("ici_bytes", "dcn_bytes",
                                "dcn_collectives")}
        assert jcost.reassociation_ulp_bound(closed, {"clients": 8}) == \
            costmodel.reassociation_ulp_bound(
                [("all_reduce", "clients", (16, 4), "float32")],
                {"clients": 8}) == 7
    assert set(shardaudit.MESH_RULE_DOCS) == set(jshard.MESH_RULE_DOCS) - {
        "AU009", "AU011"}
