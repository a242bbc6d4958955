"""A tiny cell for the CPU tests: a 2-layer GPT2 of width 32 (the
program's --test model) over a corpus of 8 personas, its own
BENCHMARK.json in a temporary directory, found beside the benchmark's
own files."""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FLAGS = ["--test", "--dataset_name", "PERSONA", "--mode", "sketch",
         "--error_type", "virtual", "--virtual_momentum", "0.9",
         "--local_momentum", "0", "--k", "60", "--num_rows", "5",
         "--num_cols", "1000", "--weight_decay", "5e-4", "--lr_scale",
         "0.04", "--max_history", "2", "--num_candidates", "2"]
CONFIG = {"source": "the program's --test GPT2", "n_embd": 32,
          "n_layer": 2, "n_head": 2, "n_positions": 8, "vocab_size": 500,
          "flags": FLAGS}
CORPUS = {"personas": 8, "dialogs_per_persona": 1,
          "utterances_per_dialog": 6, "valid_dialogs": 2, "traits": 2,
          "trait_words": 5, "turn_words": 3, "candidate_words": 4,
          "candidates": 2, "vocabulary": 300}
TRAFFIC = {"clients_per_round": 4, "examples_per_client": 2,
           "corpus": CORPUS}
# CPU readings of sound runs are 0 to 3e-7 (float32 rounding of the
# same operations in another order)
LIMITS = {"batch_rows_bad": 0, "upload_bytes_gap": 0, "loss_gap": 1e-5,
          "table_gap": 1e-5, "select_gap": 1e-3, "download_gap": 1e-3,
          "change_gap": 1e-4, "state_gap": 1e-4}
CELL = "tiny.t4x2"


def write_cell(tmp, bench=None) -> str:
    """The tiny cell's files under `tmp` and a BENCHMARK.json (the
    benchmark's own, or `bench`) holding it as one more cell; returns
    that file's path."""
    for sub, name, obj in (("configs", "tiny.json", CONFIG),
                           ("traffic", "t4x2.json", TRAFFIC),
                           ("limits", CELL + ".json", LIMITS)):
        os.makedirs(os.path.join(tmp, sub), exist_ok=True)
        with open(os.path.join(tmp, sub, name), "w") as f:
            json.dump(obj, f)
    if bench is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
        bench["workloads"].append({"name": CELL, "config": "tiny",
                                   "traffic": "t4x2", "chips": 1,
                                   "why": "the CPU tests' cell"})
        for m in bench["per_layer"]:
            m.setdefault("workloads", []).append(CELL)
    path = os.path.join(tmp, "BENCHMARK.json")
    with open(path, "w") as f:
        json.dump(bench, f)
    return path


def load(tmp):
    from portbench import spec
    path = write_cell(str(tmp))
    return spec.load_cell(CELL, path, [str(tmp), BENCH])
