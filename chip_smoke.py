#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own line; any failure exits non-zero before
the result line:

1. device   — a CUDA card or fail; its name and power limit
               (nvidia-smi).
2. build    — the port's CUDA kernels, built from the checkout's
               sources into build/ (nvcc, sm_90a).
3. kernels  — K1 (count-sketch encode) and K2 (median estimate of every
               coordinate) against their plain PyTorch versions at the
               main-path shapes and three small geometries (padded tail /
               odd r, exact fit / even r, one chunk with c > d). Tolerance:
               exact equality (bitwise up to the sign of zero). Times with
               CUDA events (median after warm-up, L2 flushed between
               launches), next to the least time the card needs for the
               same bytes and operations.
4. main     — the port's cv_train.train() on the full-width ResNet9
               (D = 6,568,640), BASELINE config #2 (`--mode sketch
               --error_type virtual --virtual_momentum 0.9 --local_momentum
               0 --num_workers 8 --k 50000 --num_rows 5 --num_cols 500000`),
               8 clients x 32 examples a round, 10 rounds over a synthetic
               CIFAR corpus of 100 clients. Every loss finite, the weights
               moved, K1 and K2 launched once a round each.
5. parity   — one round's client gradient sum, sketch table and top-k
               from the same weights and batch on the card and on the CPU
               (plain kernel versions, TF32 off), beside a float64 CPU
               gradient: relative error <= 2e-3 card vs CPU, the card no
               less accurate than the CPU against float64, and >= 99% of
               the top-k indices shared (PARITY_RTOL and its note).

The line before the last holds {"kernels": [...]} and the card's name
and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
`--profile [DIR]` additionally traces three rounds with torch.profiler
and writes the device time by kernel to DIR/profile_rounds.txt
(chiprun_out/ beside the script by default).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and float32
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

MAIN_D, MAIN_C, MAIN_R = 6_568_640, 500_000, 5
SMALL_GEOMETRIES = [
    dict(d=1000, c=200, r=5),       # padded tail, odd r
    dict(d=512, c=128, r=4),        # exact fit, even r
    dict(d=300, c=400, r=3),        # single chunk, c > d
]
CONFIG2 = ["--mode", "sketch", "--error_type", "virtual",
           "--virtual_momentum", "0.9", "--local_momentum", "0",
           "--num_workers", "8", "--k", "50000", "--num_rows", "5",
           "--num_cols", "500000"]
ROUNDS = 10
# card-vs-CPU tolerances. A float32 backward of the full-width ResNet9
# over 256 images sits 1e-4 to 1e-3 (relative L2, depending on weights
# and batch) from its float64 value on EITHER device — rounding, which
# this phase measures against a float64 CPU gradient — so two float32
# devices may differ by about that much: 2e-3 is the bound. The card
# must also be as accurate as the CPU against float64: within
# ACCURACY_RATIO x the CPU's float32 error, or ACCURACY_RATIO x
# ACCURACY_FLOOR when the CPU happens to land closer than the usual
# float32 error of this backward. Rounding moves the top-k boundary by
# a few coordinates only.
PARITY_RTOL = 2e-3
ACCURACY_RATIO = 3.0
ACCURACY_FLOOR = 2e-4
TOPK_OVERLAP = 0.99
CLIENTS = 100
EXAMPLES_PER_CLIENT = 64     # 100 x 64 / (8 x 32) = 25 rounds an epoch


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """Registers and spill bytes of K1 and K2 at r = 5 from the build's
    `-Xptxas -v` report (empty when the library was already built)."""
    import re
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            fn = ("encode_kernel" if "encode_kernel" in name
                  else "estimate_kernel<5>" if "estimate_kernelILi5E" in name
                  else None)
            continue
        if fn and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        if fn and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            out.append(f"{fn}: {regs} registers, {spill} bytes spilled")
            fn = None
    return "; ".join(out)


def time_cuda(fn, iters: int, warmup: int = 3, flush: bool = True) -> float:
    """Median ms of `fn` over `iters` launches, CUDA events around each,
    the 50 MB L2 overwritten before each (the round finds its inputs
    cold: they are written by other kernels in between)."""
    scratch = torch.empty(96 * 2 ** 20 // 4, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush:
            scratch.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_phase(sc, CSVec):
    """K1 / K2 against their plain versions; returns the per-kernel
    result rows (launch counts filled in after the main path)."""
    dev = torch.device("cuda")
    max_err = {"sketch_encode": 0.0, "sketch_estimate_all": 0.0}
    for geom in SMALL_GEOMETRIES + [dict(d=MAIN_D, c=MAIN_C, r=MAIN_R)]:
        sk = CSVec(**geom)
        off, eps, delta = sk.tables(dev)
        g = torch.Generator().manual_seed(geom["d"])
        x = torch.randn(geom["d"], generator=g).to(dev)
        t_k = sc.encode(x, off, delta, eps, sk.c)
        t_p = sc.encode_plain(x, off, delta, eps, sk.c)
        e_k = sc.estimate_all(t_k, off, delta, eps, sk.d)
        e_p = sc.estimate_all_plain(t_k, off, delta, eps, sk.d)
        torch.cuda.synchronize()
        for name, k, p in (("sketch_encode", t_k, t_p),
                           ("sketch_estimate_all", e_k, e_p)):
            err = float((k - p).abs().max())
            max_err[name] = max(max_err[name], err)
            if not torch.equal(k, p):
                raise AssertionError(
                    f"{name} differs from its plain version at {geom}: "
                    f"max abs err {err}")
        phase("kernels", f"{geom}: K1 and K2 equal to their plain "
              "versions (exact)")

    # timing at the main-path shapes
    d, c, r = MAIN_D, MAIN_C, MAIN_R
    sk = CSVec(d=d, c=c, r=r)
    B = sk.n_chunks
    off, eps, delta = sk.tables(dev)
    x = torch.randn(d, generator=torch.Generator().manual_seed(1)).to(dev)
    table = sc.encode(x, off, delta, eps, c)
    rows = []

    # K1: read x once, eps once, off/delta once; write the table once.
    # Operations: r * d * (2 multiplies + 1 add) in f32.
    k1_bytes = 4 * d + 4 * r * c + 8 * r * B + 4 * r * c
    k1_ops = 3 * r * d
    # library yardstick: one index_add_ of the pre-hashed, pre-signed
    # [r * d] values into the flat table (hash and signs precomputed)
    buckets, signs = sk.hash_indices(torch.arange(d, device=dev))
    flat_pos = (torch.arange(r, device=dev)[:, None] * c
                + buckets).reshape(-1)
    src = (signs * x[None, :]).reshape(-1)
    lib_out = torch.zeros(r * c, device=dev)
    rows.append(dict(
        name="sketch_encode", route="cuda",
        source="commefficient_tpu_torch/ops/csrc/sketch.cu",
        replaces="commefficient_tpu/ops/kernels/sketch_pallas.py:146",
        fn=lambda: sc.encode(x, off, delta, eps, c),
        plain=lambda: sc.encode_plain(x, off, delta, eps, c),
        library=lambda: lib_out.zero_().index_add_(0, flat_pos, src),
        bytes=k1_bytes, ops=k1_ops))
    # K2: read the table, eps, off/delta once; write the [B, c]
    # estimate once. Operations per estimate: 2r multiplies, the
    # r(r-1)/2 compare-exchanges (2 each), the middle.
    k2_bytes = 4 * r * c + 4 * r * c + 8 * r * B + 4 * B * c
    k2_ops = B * c * (2 * r + r * (r - 1) + 2)
    rows.append(dict(
        name="sketch_estimate_all", route="cuda",
        source="commefficient_tpu_torch/ops/csrc/sketch.cu",
        replaces="commefficient_tpu/ops/kernels/sketch_pallas.py:191",
        fn=lambda: sc.estimate_all(table, off, delta, eps, d),
        plain=lambda: sc.estimate_all_plain(table, off, delta, eps, d),
        library=None, bytes=k2_bytes, ops=k2_ops))

    out = []
    for row in rows:
        t_bytes = row["bytes"] / PEAK_BYTES_PER_S * 1e3
        t_ops = row["ops"] / PEAK_F32_FLOPS * 1e3
        res = dict(
            name=row["name"], route=row["route"], source=row["source"],
            replaces=row["replaces"], launches=0,
            max_abs_err=max_err[row["name"]],
            ms=time_cuda(row["fn"], 50),
            plain_ms=time_cuda(row["plain"], 5, warmup=1),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=(None if row["library"] is None
                        else time_cuda(row["library"], 20)))
        phase("kernels", f"{res['name']}: kernel_ms={res['ms']:.4f} "
              f"plain_ms={res['plain_ms']:.4f} bound_ms="
              f"{res['bound_ms']:.4f} ({res['bound_by']}) library_ms="
              f"{res['library_ms']}")
        out.append(res)
    del buckets, signs, flat_pos, src, lib_out
    return out


class TimedLoader:
    """The train loader with the host time spent producing each round's
    batch recorded (sampling, fetch, augmentation, stacking)."""

    def __init__(self, inner):
        self.inner = inner
        self.seconds = []

    @property
    def steps_per_epoch(self):
        return self.inner.steps_per_epoch

    def epoch(self):
        it = iter(self.inner.epoch())
        while True:
            t = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.seconds.append(time.perf_counter() - t)
            yield item


def main_path(sc, cv_train, parse_args, data_dir):
    """Drive cv_train.train() for ROUNDS rounds of config #2; returns
    (model, per-round ms, peak bytes, launches, a batch for parity)."""
    n_train = CLIENTS * EXAMPLES_PER_CLIENT
    spe = math.ceil(n_train / (8 * 32))
    cfg = parse_args(argv=CONFIG2 + [
        "--local_batch_size", "32", "--num_clients", str(CLIENTS),
        "--device", "cuda", "--dataset_dir", data_dir,
        "--num_epochs", str(ROUNDS / spe),
        "--pivot_epoch", str(ROUNDS / spe / 2), "--seed", "21"])
    model, opt, sched, train_loader, val_loader = cv_train.build(
        cfg, device="cuda", synthetic_examples=(n_train, 512))
    assert model.cfg.grad_size == MAIN_D, model.cfg.grad_size
    assert train_loader.steps_per_epoch == spe
    w0 = model.ps_weights.clone()
    stamps, losses = [], []

    def on_round(i, out):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(out[0])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sc.reset_launches()
    t0 = time.perf_counter()
    timed = TimedLoader(train_loader)
    ok = cv_train.train(model, opt, sched, timed, val_loader,
                        model.cfg, on_round=on_round)
    torch.cuda.synchronize()
    launches = dict(sc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if not ok:
        raise AssertionError("train() reported a NaN/divergent loss")
    if len(stamps) != ROUNDS:
        raise AssertionError(f"{len(stamps)} rounds ran, {ROUNDS} expected")
    loss_vals = torch.stack(losses).cpu()
    if not torch.isfinite(loss_vals).all():
        raise AssertionError(f"non-finite losses: {loss_vals}")
    if torch.equal(model.ps_weights, w0):
        raise AssertionError("the weights did not move")
    for name in ("sketch_encode", "sketch_estimate_all"):
        if launches[name] != ROUNDS:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {ROUNDS} rounds (one a round "
                                 "expected)")
    round_ms = [1e3 * (b - a) for a, b in
                zip([t0] + stamps[:-1], stamps)]
    phase("main", f"{ROUNDS} rounds, D={MAIN_D}, mean client loss "
          f"first/last {float(loss_vals[0].mean()):.4f}/"
          f"{float(loss_vals[-1].mean()):.4f}, launches {launches}")
    phase("main", "ms/round " + " ".join(f"{t:.2f}" for t in round_ms)
          + f"; median (rounds 2-{ROUNDS}) "
          f"{statistics.median(round_ms[1:]):.2f}, of which the host "
          f"makes the batch (data) "
          f"{1e3 * statistics.median(timed.seconds[1:ROUNDS]):.2f}; peak "
          "memory "
          f"{peak / 2 ** 30:.3f} GiB (max_memory_allocated)")
    batch = next(iter(train_loader.epoch()))
    return model, round_ms, peak, launches, batch


def parity_phase(model, batch, models, fclient, fserver, flat, convert):
    """One round's gradient sum, table and top-k on the card vs the
    CPU, from the same weights and batch, with a float64 CPU gradient
    as the yardstick of float32 reduction-order noise."""
    from commefficient_tpu_torch.training.cv_train import make_compute_loss
    cfg = model.cfg
    client_ids, data, mask = batch
    out = {}
    for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                       ("cpu", torch.float64)):
        module = models.build_model("ResNet9", num_classes=10)
        convert.load_flat(module, model.ps_weights.detach().cpu())
        module = module.to(dev, dtype)
        _, unravel = flat.flatten_params(module)
        loss = fclient.make_flat_loss_fn(make_compute_loss(module), unravel)
        w = model.ps_weights.detach().to(dev, dtype)
        xs = (torch.from_numpy(data[0]).to(dev, dtype),
              torch.from_numpy(data[1]).to(dev))
        m = torch.from_numpy(mask).to(dev, dtype)
        g, _, _, counts = fclient.fused_shard_grads(loss, w, xs, m, cfg)
        if dtype == torch.float64:
            out["f64"] = (g.cpu(), None, None)
            continue
        table = fserver.args2sketch(cfg).encode(g) / counts.sum()
        r, c = cfg.num_rows, cfg.num_cols
        zeros = torch.zeros((r, c), device=dev)
        upd = fserver.get_server_update(table, zeros, zeros, cfg, 1.0)
        top = set(torch.nonzero(upd.update).reshape(-1).cpu().tolist())
        out[dev] = (g.cpu(), table.cpu(), top)
    (gc, tc, kc), (gp, tp, kp) = out["cuda"], out["cpu"]
    g64 = out["f64"][0]

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    g_err, t_err = rel(gc, gp), rel(tc, tp)
    card64, cpu64 = rel(gc, g64), rel(gp, g64)
    overlap = len(kc & kp) / max(len(kp), 1)
    phase("parity", f"card vs CPU: grad rel err {g_err:.3e}, table rel "
          f"err {t_err:.3e} (tolerance {PARITY_RTOL:g}); vs the float64 "
          f"CPU gradient: card {card64:.3e}, CPU float32 {cpu64:.3e} "
          f"(card <= {ACCURACY_RATIO:g} x max(CPU, {ACCURACY_FLOOR:g})); "
          f"top-k overlap "
          f"{overlap:.5f} of {len(kp)} (>= {TOPK_OVERLAP:g})")
    if not (g_err <= PARITY_RTOL and t_err <= PARITY_RTOL
            and card64 <= ACCURACY_RATIO * max(cpu64, ACCURACY_FLOOR)
            and overlap >= TOPK_OVERLAP):
        raise AssertionError("card and CPU disagree beyond tolerance")
    return g_err, t_err, overlap


def profile_rounds(model, train_loader, opt, path):
    """Device time by kernel over three traced rounds (after one
    untraced and one warm-up round of the profiler's schedule)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    it = iter(train_loader.epoch())
    batches = [next(it) for _ in range(5)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=3)) as prof:
        for i, b in enumerate(batches):
            if i == 2:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            model(b)
            opt.step()
            prof.step()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    # kernels only: the ProfilerStep* rows annotate whole steps on the
    # device timeline and would count the steps' spans, not work
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.key.startswith("ProfilerStep"))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"3 rounds, wall {wall_ms:.2f} ms (traced), device busy "
                f"{dev_us / 1e3:.2f} ms\n{table}\n")
    phase("profile", f"3 traced rounds: wall {wall_ms:.2f} ms, kernels on "
          f"the device {dev_us / 1e3:.2f} ms (busy share "
          f"{dev_us / 1e3 / wall_ms:.3f}); table in {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", nargs="?", metavar="DIR", default=None,
                    const=os.path.join(HERE, "chiprun_out"),
                    help="trace three more rounds with torch.profiler and "
                         "write profile_rounds.txt into DIR (default "
                         "chiprun_out/ beside this script)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from commefficient_tpu_torch import models
    from commefficient_tpu_torch.config import parse_args
    from commefficient_tpu_torch.device import resolve_device
    from commefficient_tpu_torch.federated import client as fclient
    from commefficient_tpu_torch.federated import server as fserver
    from commefficient_tpu_torch.models import convert
    from commefficient_tpu_torch.ops import flat
    from commefficient_tpu_torch.ops.kernels import sketch_cuda as sc
    from commefficient_tpu_torch.ops.sketch import CSVec
    from commefficient_tpu_torch.training import cv_train

    resolve_device("cuda")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind}; nvidia-smi name, power.limit: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    sc.build()
    phase("build", f"nvcc sm_90a build of {sorted(sc.SOURCES)} in "
          f"{time.perf_counter() - t0:.2f} s (0 when already built); "
          f"ptxas: {ptxas_summary(sc.BUILD_LOG.get('sketch', ''))}")

    kernels = kernel_phase(sc, CSVec)
    data_dir = os.path.join(HERE, "build", "chip_smoke_data")
    model, round_ms, peak, launches, batch = main_path(
        sc, cv_train, parse_args, data_dir)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    parity_phase(model, batch, models, fclient, fserver, flat, convert)
    if args.profile:
        profile_rounds(model, cv_train.get_data_loaders(
            model.cfg, (CLIENTS * EXAMPLES_PER_CLIENT, 512))[0],
            model._optimizer, os.path.join(args.profile,
                                           "profile_rounds.txt"))

    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:   # report the failing phase, exit non-zero
        traceback.print_exc()
        code = 1
    sys.exit(code)
