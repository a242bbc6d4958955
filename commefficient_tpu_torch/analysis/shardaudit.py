"""graftmesh: the port of commefficient_tpu/analysis/shardaudit.py, over
a real rank world instead of sharding-annotated programs.

The JAX tier traces the round programs under explicit meshes; the
port's mesh positions are ranks and its collectives are the calls of a
`parallel/mesh.Layout`. So this tier RUNS parallel/mh_worker's `base`
scenario (its model, loss and round config, the population raised to
the sentinel MESH_POPULATION) as a 2-rank gloo world on the CPU, one
world per layout:

  clients2      make_client_mesh(2): a 1-D `clients` axis in one slice
  multislice2   make_multihost_client_mesh(num_slices=2): the --num_slices
                emulation, rank i in slice i % 2, so the `clients` axis
                spans the two slices (the inter-slice link)

Each rank drives one warm round, then one round and one span of SPAN_LEN
rounds with its Layout's collective log on (CollectiveStats.log, each
entry stamped with its round stage), and writes what it saw. Programs
are the stages of the round (`base/gather`, `base/round`,
`base/scatter`) and the span (`base/span`), each `@layout`. The rules:

  AU007  client rows replicated: a rank's client-state block holds more
         than its share, ceil(population / clients) rows.
  AU008  a collective payload shaped by the population sentinel: the
         wire cost scales with num_clients, not the cohort.
  AU010  model-axis traffic across slices, or more than one table-sized
         (>= DCN_TABLE_BYTES) reduction across slices a round in one
         stage (the span counts each stage of its rounds apart, as the
         JAX package counts each program).

and a per-link byte report for every program (costmodel.collective_cost,
the JAX package's hierarchical-ring model over the logged calls), gated
exact-match by the port's own baseline (analysis/baselines/
meshaudit.json, drift rule MAU006). AU009 (an operand without an
explicit sharding) and AU011 (a re-layout the one-device program does
not have) have no reading here: a rank's tensors live on its one device
and nothing lays them out implicitly (ROADMAP.md, "Not to port").

CLI: ``python -m commefficient_tpu_torch.analysis.shardaudit``; exit
codes 0 clean, 1 violations, 2 drift only, 3 usage. The report is
canonical JSON with a sha256 digest, bit-identical across runs, and
journals as a `mesh_audit_digest` event.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

from commefficient_tpu_torch.analysis.audit import (
    AUDIT_GEOMETRY, AuditBaseline, AuditFinding, canonical_digest,
    common_args, finish,
)
from commefficient_tpu_torch.analysis.costmodel import (
    MeshLinkModel, collective_cost, reassociation_ulp_bound,
)

MESH_RULE_DOCS = {
    "AU007": "client rows replicated: a rank holds more than its share "
             "of the client-state rows",
    "AU008": "collective payload scales with the client POPULATION "
             "rather than the cohort",
    "AU010": "collective on the wrong link class: model-axis traffic "
             "across slices, or > 1 table-sized cross-slice reduction "
             "per round",
}

# the population sentinel (the JAX package's): divisible by the clients
# axes, distinct from every other dimension
MESH_POPULATION = 184

# the span program's rounds (the JAX package's)
SPAN_LEN = 2

# a table-sized payload: the JAX package's --dcn-table-bytes default
DCN_TABLE_BYTES = 1024

# layout name -> the --num_slices of its world (2 ranks each)
LAYOUTS = {"clients2": 1, "multislice2": 2}
WORLD = 2
PROGRAMS = ("gather", "round", "scatter", "span")

DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baselines", "meshaudit.json")


class MeshBaseline(AuditBaseline):
    """The per-link block, diffed exact-match (the JAX MeshBaseline)."""
    COST_KEY = "links"
    COST_FIELDS = ("ici_bytes", "dcn_bytes", "dcn_collectives")
    DRIFT_RULE = "MAU006"


def link_model(name: str) -> MeshLinkModel:
    slices = LAYOUTS[name]
    return MeshLinkModel(name, (("clients", WORLD),),
                         (("clients", slices),))


# ---------------------------------------------------------------------------
# one rank of the world


def run_rank(out_path: str, layout_name: str) -> None:
    """This rank's round and span of the base scenario, logged; writes
    {log, span_log, rows, local_rows} as JSON (torch.distributed is up)."""
    import numpy as np

    from commefficient_tpu_torch.analysis.recorder import RoundRecorder
    from commefficient_tpu_torch.federated.api import FedModel, FedOptimizer
    from commefficient_tpu_torch.federated.round import local_rows
    from commefficient_tpu_torch.parallel import mh_worker
    from commefficient_tpu_torch.parallel import multihost as mh
    from commefficient_tpu_torch.parallel.mesh import (
        make_client_mesh, make_multihost_client_mesh,
    )
    layout = (make_client_mesh(WORLD) if LAYOUTS[layout_name] == 1
              else make_multihost_client_mesh(num_slices=LAYOUTS[
                  layout_name]))
    module, _ = mh_worker.make_model("base")
    fed = FedModel(module, mh_worker.make_loss(module),
                   mh_worker.scenario_config(
                       {"num_clients": MESH_POPULATION}),
                   device="cpu", num_clients=MESH_POPULATION, layout=layout)
    opt = FedOptimizer(fed)
    opt.param_groups[0]["lr"] = 0.1
    sl = mh.local_row_slice(fed.layout, mh_worker.W)
    batches = mh_worker.scenario_batches("base")
    ids, x, y, mask = batches[0]
    fed((ids, (x[sl], y[sl]), mask[sl]))            # caches filled
    stats = fed.layout.stats
    stats.log = []
    ids, x, y, mask = batches[1]
    with RoundRecorder():
        fed((ids, (x[sl], y[sl]), mask[sl]))
    round_log, stats.log = stats.log, []
    span = batches[2:2 + SPAN_LEN]
    with RoundRecorder():
        fed.run_rounds(np.stack([b[0] for b in span]),
                       (np.stack([b[1][sl] for b in span]),
                        np.stack([b[2][sl] for b in span])),
                       np.stack([b[3][sl] for b in span]),
                       np.full((SPAN_LEN,), 0.1, np.float32))
    span_log, stats.log = stats.log, None
    doc = {"rank": mh.process_index(), "log": round_log,
           "span_log": span_log,
           "rows": {f: list(getattr(fed.clients, f).shape)
                    for f in fed.clients._fields},
           "local_rows": local_rows(MESH_POPULATION, fed.layout)}
    tmp = out_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f)
    os.replace(tmp, out_path)


def run_worlds(layouts: Sequence[str] = tuple(LAYOUTS),
               timeout: float = 300.0) -> Dict[str, List[dict]]:
    """{layout: [rank 0's doc, rank 1's doc]}: every world spawned at
    once, each rank a subprocess on one thread."""
    import subprocess

    from commefficient_tpu_torch.parallel.mh_worker import free_port
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [repo] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for name in layouts:
            port = free_port()
            for i in range(WORLD):
                out = os.path.join(tmp, f"{name}.{i}.json")
                procs.append((name, out, subprocess.Popen(
                    [sys.executable, "-m",
                     "commefficient_tpu_torch.analysis.shardaudit",
                     "--rank-of", name, "--process_id", str(i),
                     "--port", str(port), "--out", out],
                    cwd=repo, env=env, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT)))
        try:
            logs = [p.communicate(timeout=timeout)[0].decode()
                    for _, _, p in procs]
        finally:
            for _, _, p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for (name, _, p), log in zip(procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"graftmesh rank of {name} exited "
                                   f"{p.returncode}:\n{log[-3000:]}")
        out: Dict[str, List[dict]] = {}
        for name, path, _ in procs:
            with open(path, encoding="utf-8") as f:
                out.setdefault(name, []).append(json.load(f))
    return out


# ---------------------------------------------------------------------------
# findings


def program_logs(doc: dict) -> Dict[str, list]:
    """{program: its log entries} of one rank's doc."""
    out = {p: [] for p in PROGRAMS}
    for e in doc["log"]:
        if e[4] in out:
            out[e[4]].append(e)
    out["span"] = list(doc["span_log"])
    return out


def collective_findings(program: str, cost, population: int,
                        table_bytes: int, rounds: int
                        ) -> List[AuditFinding]:
    """AU008 + AU010 over one program's priced collectives."""
    out: List[AuditFinding] = []
    crossings: Dict[Optional[str], int] = {}
    for rec in cost.records:
        if any(population in shape for shape in rec.operand_shapes):
            out.append(AuditFinding(
                program, "AU008",
                f"`{rec.kind}` over {list(rec.axes)} moves a "
                f"population-shaped payload {list(rec.operand_shapes)}: "
                "the wire cost scales with num_clients, not the cohort "
                "— gather the sampled rows before the collective"))
        if rec.crosses_dcn and "model" in rec.axes:
            out.append(AuditFinding(
                program, "AU010",
                f"`{rec.kind}` over the `model` axis crosses slices: "
                "model-parallel collectives are per-layer traffic and "
                "stay inside a slice (model axis innermost)"))
        if (rec.crosses_dcn and rec.kind == "all_reduce"
                and rec.payload_bytes >= table_bytes):
            crossings[rec.stage] = crossings.get(rec.stage, 0) + rec.mult
    for stage, n in sorted(crossings.items(), key=str):
        if n > rounds:
            out.append(AuditFinding(
                program, "AU010",
                f"{n} table-sized (>= {table_bytes} B) cross-slice "
                f"reductions in the `{stage}` stage across {rounds} "
                "round(s): the contract is ONE across slices a round in "
                "each of the round and its two state-motion programs"))
    return sorted(out)


def replication_findings(program: str, doc: dict) -> List[AuditFinding]:
    """AU007: a tracked client-state block with more rows than the
    rank's share."""
    out = []
    for field, shape in sorted(doc["rows"].items()):
        if len(shape) == 2 and shape[0] > doc["local_rows"]:
            out.append(AuditFinding(
                program, "AU007",
                f"client rows `clients.{field}` {shape} on rank "
                f"{doc['rank']}: more than its share of "
                f"{doc['local_rows']} rows — the population's rows are "
                "replicated instead of sharded by rank"))
    return out


def run_mesh_audit(layouts: Sequence[str] = tuple(LAYOUTS),
                   worlds: Optional[Dict[str, List[dict]]] = None
                   ) -> Tuple[dict, List[AuditFinding]]:
    """Run (or take) the worlds; returns (report, findings)."""
    worlds = worlds if worlds is not None else run_worlds(layouts)
    programs: Dict[str, dict] = {}
    findings: List[AuditFinding] = []
    for name in layouts:
        link = link_model(name)
        docs = sorted(worlds[name], key=lambda d: d["rank"])
        logs = program_logs(docs[0])
        for prog_name in PROGRAMS:
            prog = f"base/{prog_name}@{name}"
            cost = collective_cost(logs[prog_name], link)
            rounds = SPAN_LEN if prog_name == "span" else 1
            findings.extend(collective_findings(
                prog, cost, MESH_POPULATION, DCN_TABLE_BYTES, rounds))
            programs[prog] = dict(
                cost.as_dict(),
                ulp=reassociation_ulp_bound(logs[prog_name],
                                            dict(link.axis_sizes)))
        for doc in docs:
            findings.extend(replication_findings(f"base/rows@{name}", doc))
    report = {
        "version": 1,
        "geometry": dict(AUDIT_GEOMETRY, population=MESH_POPULATION,
                         span_len=SPAN_LEN, world=WORLD),
        "meshes": {n: link_model(n).as_dict() for n in sorted(layouts)},
        "programs": {p: programs[p] for p in sorted(programs)},
        "links": {p: {"ici_bytes": d["ici_bytes"],
                      "dcn_bytes": d["dcn_bytes"],
                      "dcn_collectives": d["dcn_collectives"]}
                  for p, d in sorted(programs.items())},
    }
    report["digest"] = canonical_digest(
        {"geometry": report["geometry"], "meshes": report["meshes"],
         "links": report["links"]})
    return report, sorted(findings)


def journal_digest(journal_path: str, report: dict,
                   findings_count: int) -> dict:
    """Append the report as a `mesh_audit_digest` journal event."""
    from commefficient_tpu_torch.telemetry.journal import append_event
    return append_event(journal_path, "mesh_audit_digest",
                        digest=report["digest"],
                        geometry=report["geometry"],
                        meshes=report["meshes"],
                        programs=report["links"],
                        findings=int(findings_count))


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="graftmesh",
        description="rank-world auditor of the port's collectives: "
                    "replicated rows, population-sized payloads, link "
                    "classes, the per-link byte baseline (rules "
                    "AU007, AU008, AU010). Exit codes: 0 clean, 1 "
                    "violations, 2 drift only.")
    common_args(ap, DEFAULT_BASELINE)
    ap.add_argument("--rank-of", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--process_id", type=int, default=0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--out", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_of is not None:
        from commefficient_tpu_torch.parallel import multihost as mh
        mh.initialize(coordinator_address=f"127.0.0.1:{args.port}",
                      num_processes=WORLD, process_id=args.process_id,
                      backend="gloo", device="cpu")
        try:
            run_rank(args.out, args.rank_of)
        finally:
            mh.shutdown()
        return 0
    if args.list_rules:
        for code, doc in sorted(MESH_RULE_DOCS.items()):
            print(f"{code}  {doc}")
        return 0
    report, findings = run_mesh_audit()
    return finish("graftmesh", args, report, findings, MeshBaseline,
                  "links", journal_digest)


if __name__ == "__main__":
    sys.exit(main())
