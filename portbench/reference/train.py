"""The plain reference's first training steps of a sketched federated
GPT2 round: each client's loss, the cohort's gradient sum (with the
weight-decay term every client adds), its sketch divided by the
cohort's example count, the server step, the learning rate of the
schedule, and the bytes the clients upload and download.

Runs in float32; `tf32=True` lets the matrix products round their
inputs to TF32 (the lower-precision control).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch

from portbench.reference import gpt2, sketch


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def learning_rate(spec: dict, step: int) -> float:
    """The training loop's schedule: linear from lr to 0 over num_epochs
    epochs, read after `step + 1` scheduler steps."""
    total = spec["num_epochs"] * spec["steps_per_epoch"]
    return float(np.interp([step + 1], [0, total], [spec["lr"], 0.0])[0])


def run_steps(spec: dict, leaves: List[gpt2.Leaf], w: torch.Tensor,
              batches: list, tf32: bool = False) -> Dict[str, object]:
    """`batches`: each step's (client_ids [W], arrays [W, B, ...] in the
    loader's order, mask [W, B]). Returns each step's client losses,
    the first step's gradient table, per-leaf gradient norms and
    weights, the server tables and the weights after the last step, and
    the bytes."""
    dev = w.device
    sk = sketch.Sketch(w.numel(), spec["num_cols"], spec["num_rows"], dev)
    V = torch.zeros(sk.r, sk.c, device=dev)
    E = torch.zeros_like(V)
    out: Dict[str, object] = {"losses": [], "downloads": [], "uploads": []}
    changes: List[torch.Tensor] = []
    seen: dict = {}
    wire = 4.0 * sk.r * sk.c
    with matmul_precision(tf32):
        for t, (ids, arrays, mask) in enumerate(batches):
            out["downloads"].append(sketch.downloads(
                changes[-spec["change_depth"]:], seen, t, ids,
                spec["change_depth"]))
            out["uploads"].append(np.full(len(ids), wire))
            for cid in np.asarray(ids).reshape(-1):
                seen[int(cid)] = t
            m = torch.as_tensor(mask, dtype=torch.float32, device=dev)
            counts = m.sum(dim=1)
            wg = w.detach().clone().requires_grad_(True)
            p = gpt2.unflatten(wg, leaves)
            losses = []
            for c in range(m.shape[0]):
                batch = tuple(torch.as_tensor(a[c], device=dev)
                              for a in arrays)
                loss = gpt2.client_loss(p, spec["n_layer"], spec["n_head"],
                                        batch, m[c])
                (loss * counts[c]).backward()
                losses.append(loss.detach())
            grad = wg.grad + (spec["weight_decay"] / spec["num_workers"]
                              ) * w * counts.sum()
            del wg, p
            out["losses"].append(torch.stack(losses))
            total = counts.sum().clamp(min=1.0)
            table = sk.encode(grad) / total
            if t == 0:
                out["grad_leaf_norms"] = torch.stack([
                    grad[lf.offset:lf.offset + lf.size].norm()
                    for lf in leaves])
            update, V, E = sketch.server_step(sk, table, V, E, spec["k"],
                                              spec["virtual_momentum"])
            if t == 0:
                out["table1"], out["E1"] = V.clone(), E.clone()
            w_new = w - learning_rate(spec, t) * update
            changes.append(w_new != w)
            w = w_new
            if t == 0:
                out["w1"] = w
            del grad, table, update
    out["V"], out["E"], out["w"] = V, E, w
    out["losses"] = torch.stack(out["losses"])
    return out
