"""The harness is driven by data: a new cell and a seventh per-layer
metric come from new files in a temporary directory alone, and the
benchmark's own files agree with BENCHMARK.json."""
import json
import os
import re

import pytest
import torch

from portbench.tests import tiny
from portbench import harness, run, spec

METRIC = '''
LAYER = "data"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "round_ms"


def read(run):
    return 1e3 * max(run.batch_s) if run.batch_s else None
'''


@pytest.fixture(autouse=True)
def _threads():
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


def _bench():
    with open(os.path.join(tiny.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_a_new_cell_and_a_seventh_metric_from_new_files(tmp_path):
    before = {p: os.path.getmtime(os.path.join(tiny.BENCH, p))
              for p in os.listdir(tiny.BENCH)}
    bench = _bench()
    assert len(bench["workloads"]) == 3 and len(bench["per_layer"]) == 6
    bench["workloads"].append({"name": tiny.CELL, "config": "tiny",
                               "traffic": "t4x2", "chips": 1,
                               "why": "a cell added by files alone"})
    for m in bench["per_layer"]:
        m["workloads"].append(tiny.CELL)
    bench["per_layer"].append({"name": "data.batch_max_ms", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "data", "moves": "round_ms",
                               "workloads": [tiny.CELL]})
    path = tiny.write_cell(str(tmp_path), bench)
    os.makedirs(tmp_path / "metrics")
    (tmp_path / "metrics" / "data.batch_max_ms.py").write_text(METRIC)
    dirs = [str(tmp_path), tiny.BENCH]
    cell = spec.load_cell(tiny.CELL, path, dirs)
    assert [m["name"] for m in cell.per_layer][-1] == "data.batch_max_ms"
    r = harness.run(cell, 12345, 0.5, True, "cpu")
    line = run.result_line(r, True, {"platform": "cpu"}, dirs)
    assert "data.batch_max_ms" in line["metrics"]
    assert "data.batch_ms" in line["metrics"]
    assert list(line)[-1] == "checks" and line["correct"]
    line0 = run.result_line(r, False, {"platform": "cpu"}, dirs)
    assert set(line0["metrics"]) == {"round_ms", "setup_s"}
    after = {p: os.path.getmtime(os.path.join(tiny.BENCH, p))
             for p in os.listdir(tiny.BENCH)}
    assert after == before


def test_every_entry_has_its_files():
    bench = _bench()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], os.path.join(tiny.ROOT,
                                                      "BENCHMARK.json"))
        assert cell.chips == 1
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(tiny.ROOT, c["file"]))
    for m in bench["end_to_end"] + bench["per_layer"]:
        mod = spec.load_metric(m["name"])
        assert mod.UNIT == m["unit"] and mod.BETTER == m["better"]
        assert mod.SOURCE == m["source"]
        if m in bench["per_layer"]:
            assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]


def test_the_contracts_shapes():
    bench = _bench()
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert all(name.match(n) for n in names) and len(set(names)) == len(names)
    assert {"round_ms", "peak_mem_gib", "setup_s"} == {
        m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(tiny.ROOT, "BENCHMARK.json")) < 65536
