"""What a run reads: BENCHMARK.json's cell, and the files found by name
under the benchmark's folders: `configs/<config>.json`,
`traffic/<traffic>.json`, `limits/<workload>.json` and
`metrics/<metric>.py`. A later cell, configuration, traffic mix or
metric is a new file and a new entry; nothing here changes for it.

A metric file declares LAYER, UNIT, BETTER, SOURCE, MOVES (None for an
end-to-end metric) and `read(run)`, which returns a number or None when
the run holds nothing to read. The cells a metric is read in are
BENCHMARK.json's alone: its entry's `workloads`, or every cell where the
entry has none.
"""
from __future__ import annotations

import importlib.util
import json
import os
from typing import List, NamedTuple, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int


def _find(dirs: List[str], sub: str, name: str) -> str:
    for d in dirs:
        path = os.path.join(d, sub, name)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(f"no {sub}/{name} under {dirs}")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, bench_file: str,
              dirs: Optional[List[str]] = None) -> Cell:
    dirs = dirs or [HERE]
    bench = _json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench_file}")
    w = cells[workload]
    config = _json(_find(dirs, "configs", w["config"] + ".json"))
    traffic = _json(_find(dirs, "traffic", w["traffic"] + ".json"))
    limits = _json(_find(dirs, "limits", workload + ".json"))
    return Cell(workload, config, traffic, limits,
                [m for m in bench["end_to_end"] if applies(m, workload)],
                [m for m in bench["per_layer"] if applies(m, workload)],
                int(w["chips"]))


def load_metric(name: str, dirs: Optional[List[str]] = None):
    path = _find(dirs or [HERE], "metrics", name + ".py")
    mod_name = "portbench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
