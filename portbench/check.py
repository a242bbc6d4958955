"""The comparison that decides `correct`: what the timed path produced
in the rounds the window's set-up ran, against the plain reference
following the same rounds from the same weights and the same corpus.

The numbers (each held to its limit in `limits/<cell>.json`):

  batch_rows_bad     the data layer: rows of the checked rounds' batches
                     that are not the reference's tokenization of an
                     example of the client they name, rows repeated
                     across those rounds, and masks that are not whole
                     (exact: 0);
  upload_bytes_gap   the accountant's upload bytes against 4 r c a
                     client and round (exact: 0);
  loss_gap           the first round's client losses, worst relative;
  table_gap          the first gradient as the server's optimizer gets
                     it: the momentum and error tables after the first
                     round, worst row's norm, relative, over the cells
                     that neither side's first update landed in;
  select_gap         the first update's coordinates: the cells it
                     landed in (zeroed in the momentum table) on one
                     side only, over the reference's count;
  download_gap       the second round's download bytes (the first
                     update's changed coordinates), worst client,
                     relative;
  change_gap         the weights' change in the first round: the gap of
                     its norm, relative, over the leaves whose first
                     reference gradient reaches a thousandth of the
                     median leaf's (a key's bias, which softmax leaves
                     without gradient, moves by round-off alone);
  state_gap          the server's state after the last checked round:
                     the momentum and error tables, worst row's norm,
                     relative, over the cells that neither side's last
                     update landed in. The first round starts both
                     tables at zero, so only here do the virtual
                     momentum (rho V) and the error's accumulation
                     (E + V) act.

The later rounds' losses and selections and each leaf's change over
the checked rounds are read too (`readings`), not compared: one
coordinate that rounding moves across the decode's threshold changes
the error table that the next rounds decode, so on some seeds they
part by much more than rounding, and the worst small leaf most
(PERF.md, section 6). The tables' rows are steadier: such a coordinate
moves a few cells of half a million.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import gpt2, tokens, train

ORDER = ("batch_rows_bad", "upload_bytes_gap", "loss_gap", "table_gap",
         "select_gap", "download_gap", "change_gap", "state_gap")
ARRAYS = ("input_ids", "mc_token_ids", "lm_labels", "mc_labels",
          "token_type_ids")
LEAF_GRAD_FLOOR = 1e-3
# the schedule's length in epochs the runs ask for: the learning rate
# stays within 0.1% of its start over any window
SCHEDULE_EPOCHS = 1000


def flag(flags: list, name: str, kind=float):
    """A flag's value as the configuration states it."""
    if name not in flags:
        raise KeyError(f"the configuration's flags do not state {name}")
    return kind(flags[flags.index(name) + 1])


def reference_spec(cfgj: dict, traffic: dict, n_examples: int,
                   n_clients: int) -> dict:
    f = cfgj["flags"]
    W, B = traffic["clients_per_round"], traffic["examples_per_client"]
    return {"n_layer": cfgj["n_layer"], "n_head": cfgj["n_head"],
            "num_cols": flag(f, "--num_cols", int),
            "num_rows": flag(f, "--num_rows", int),
            "k": flag(f, "--k", int),
            "virtual_momentum": flag(f, "--virtual_momentum"),
            "weight_decay": flag(f, "--weight_decay"),
            "lr": flag(f, "--lr_scale"), "num_workers": W,
            "num_epochs": SCHEDULE_EPOCHS,
            "steps_per_epoch": -(-n_examples // (W * B)),
            "change_depth": int(10 / (W / n_clients))}


def judge_batches(batches: list, clients: List[List[int]],
                  arrays: Dict[str, np.ndarray]) -> Tuple[int, list]:
    """(bad rows, the reference's own arrays for the rows each round
    names). A bad row keeps the program's row so the run can go on to
    fail."""
    index = {}
    for c, ex in enumerate(clients):
        for i in ex:
            index[(c, arrays["input_ids"][i].tobytes())] = i
    bad, used, out = 0, set(), []
    for ids, data, mask in batches:
        own = [np.array(a) for a in data]
        for w, cid in enumerate(np.asarray(ids).reshape(-1)):
            for b in range(mask.shape[1]):
                if mask[w, b] != 1.0:
                    bad += 1
                    continue
                i = index.get((int(cid), data[0][w, b].tobytes()))
                if i is None or i in used or any(
                        not np.array_equal(arrays[n][i], data[k][w, b])
                        for k, n in enumerate(ARRAYS)):
                    bad += 1
                    continue
                used.add(i)
                for k, n in enumerate(ARRAYS):
                    own[k][w, b] = arrays[n][i]
        out.append((ids, tuple(own), mask))
    return bad, out


def _rows(p: torch.Tensor, r: torch.Tensor) -> dict:
    """Each row's norm on both sides, over all cells and over the cells
    that neither side's update landed in (zero on neither side), and
    the zero cells of each side and of one side only."""
    both = (p != 0) & (r != 0)
    return {"norm_p": p.norm(dim=1).tolist(), "norm_r": r.norm(dim=1).tolist(),
            "both_p": (p * both).norm(dim=1).tolist(),
            "both_r": (r * both).norm(dim=1).tolist(),
            "zero_p": (p == 0).sum(dim=1).tolist(),
            "zero_r": (r == 0).sum(dim=1).tolist(),
            "zero_xor": ((p == 0) ^ (r == 0)).sum(dim=1).tolist()}


def readings(prog: dict, ref: dict, leaves: list, w0: torch.Tensor,
             bad_rows: int) -> dict:
    """What the numbers are worked out from, and what a look at them
    needs: per-round losses and bytes, the server tables' rows after the
    first and the last checked round, each leaf's gradient and change,
    and the coordinates that changed."""
    dev = w0.device
    d1p = prog["w1"].to(dev) - w0
    d1r = ref["w1"] - w0
    dp = prog["w"].to(dev) - w0
    dr = ref["w"] - w0
    sp, sr = dp != 0, dr != 0
    leaf = []
    for i, lf in enumerate(leaves):
        sl = slice(lf.offset, lf.offset + lf.size)
        leaf.append([float(ref["grad_leaf_norms"][i]), float(dp[sl].norm()),
                     float(dr[sl].norm()), int(sp[sl].sum()),
                     int(sr[sl].sum()), int((sp[sl] & sr[sl]).sum()),
                     float(d1p[sl].norm()), float(d1r[sl].norm())])
    return {
        "bad_rows": bad_rows,
        "upload_gap": float(np.abs(np.concatenate(prog["uploads"])
                                   - np.concatenate(ref["uploads"])).sum()),
        "loss_p": prog["losses"].double().tolist(),
        "loss_r": ref["losses"].double().cpu().tolist(),
        "V1": _rows(prog["table1"].to(dev), ref["table1"]),
        "E1": _rows(prog["E1"].to(dev), ref["E1"]),
        "V3": _rows(prog["V"].to(dev), ref["V"]),
        "E3": _rows(prog["E"].to(dev), ref["E"]),
        "leaves": [lf.path for lf in leaves], "leaf": leaf,
        "moved_p": int(sp.sum()), "moved_r": int(sr.sum()),
        "moved_xor": int((sp ^ sr).sum()),
        "down_p": [np.asarray(x).tolist() for x in prog["downloads"]],
        "down_r": [np.asarray(x).tolist() for x in ref["downloads"]]}


def _gap(p, r) -> float:
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    return float(np.max(np.abs(p - r) / np.maximum(np.abs(r), 1e-30)))


def change_gap(raw: dict) -> float:
    """The gap of the first round's change's norm, relative, over the
    leaves whose first reference gradient reaches LEAF_GRAD_FLOOR of the
    median leaf's."""
    g, p, r = (np.array([x[i] for x in raw["leaf"]]) for i in (0, 6, 7))
    keep = g >= LEAF_GRAD_FLOOR * np.median(g)
    norm_p = np.sqrt((p[keep] ** 2).sum())
    norm_r = np.sqrt((r[keep] ** 2).sum())
    return float(abs(norm_p - norm_r) / max(norm_r, 1e-30))


def _download_gap(raw: dict) -> float:
    if len(raw["down_r"]) < 2:
        return 0.0
    p, r = (np.asarray(raw[k][1], np.float64) for k in ("down_p", "down_r"))
    return float(np.max(np.abs(p - r) / np.maximum(r, 1.0)))


def numbers(raw: dict) -> Dict[str, float]:
    """The compared numbers, from `readings`."""
    v1, e1 = raw["V1"], raw["E1"]
    return {
        "batch_rows_bad": float(raw["bad_rows"]),
        "upload_bytes_gap": raw["upload_gap"],
        "loss_gap": _gap(raw["loss_p"][0], raw["loss_r"][0]),
        "table_gap": max(_gap(t["both_p"], t["both_r"]) for t in (v1, e1)),
        "select_gap": sum(v1["zero_xor"]) / max(sum(v1["zero_r"]), 1),
        "download_gap": _download_gap(raw),
        "change_gap": change_gap(raw),
        "state_gap": max(_gap(raw[t]["both_p"], raw[t]["both_r"])
                         for t in ("V3", "E3"))}


def against_reference(cfgj: dict, traffic: dict, raw: dict, prog: dict,
                      seed: int, leaves: list, device,
                      tf32_program: bool = False,
                      out: dict = None) -> Dict[str, float]:
    """Run the reference over the rounds the program ran and compare.
    With `tf32_program` the program's side is the reference itself in
    TF32 (the lower-precision control); `prog` then needs only the
    batches."""
    f = cfgj["flags"]
    clients, arrays = tokens.train_examples(
        raw, cfgj["vocab_size"], flag(f, "--num_candidates", int),
        flag(f, "--max_history", int))
    bad, batches = judge_batches(prog["batches"], clients, arrays)
    spec = reference_spec(cfgj, traffic, len(arrays["mc_labels"]),
                          len(clients))
    w0 = gpt2.init_weights(leaves, seed, device)
    ref = train.run_steps(spec, leaves, w0, batches)
    if tf32_program:
        side = train.run_steps(spec, leaves, w0, batches, tf32=True)
        prog = dict(prog, losses=side["losses"].cpu(),
                    table1=side["table1"], E1=side["E1"], V=side["V"],
                    E=side["E"], w1=side["w1"],
                    w=side["w"], downloads=side["downloads"],
                    uploads=side["uploads"])
    got = readings(prog, ref, leaves, w0, bad)
    if out is not None:
        out.update(got)
    return numbers(got)


def verdict(numbers: Dict[str, float], limits: dict
            ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {value, limit}}): every number at or under its
    limit, and finite."""
    checks, ok = {}, True
    for name in ORDER:
        if name not in limits:
            continue
        v, lim = numbers[name], float(limits[name])
        checks[name] = {"value": v, "limit": lim}
        ok = ok and math.isfinite(v) and v <= lim
    missing = [k for k in limits if k not in ORDER and not k.startswith("_")]
    if missing:
        raise KeyError(f"limits name unknown numbers: {missing}")
    return ok, checks
