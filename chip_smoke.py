#!/usr/bin/env python3
"""Smoke run of the PyTorch/H100 port on one CUDA card.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own line; any failure exits non-zero before
the result line:

1. device   — a CUDA card or fail; its name and power limit
               (nvidia-smi).
2. build    — the port's CUDA kernels, built from the checkout's
               sources into build/ (one nvcc per source, sm_90a, all
               started together).
3. kernels  — K1 (count-sketch encode) and K2 (median estimate of every
               coordinate), both reading eps and delta as packed sign
               bits, against their plain PyTorch versions (float sign
               tables) at the main-path shapes and four small geometries
               (padded tail / odd r, exact fit / even r, one chunk with
               c > d, c % 4 != 0 with a ragged last chunk). Tolerance:
               exact equality (bitwise up to the sign of zero). Times with
               CUDA events (median after warm-up, L2 flushed between
               launches): the kernel's device time, and the wrapper call
               with its host work beside it (host_ms), next to the least
               time the card needs for the same bytes and operations.
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
6. kernels  — K1 and K3a/K3b (the threshold decode's sample and mask)
               against their plain versions at the GPT2 main-path
               geometry (d = 124,444,417), the three threshold
               geometries of tests/test_kernels.py (one with the stride
               clamped to c) and the four small ones of phase 3,
               exact, K3b at three thresholds each (K3_THRESHOLDS); K1
               timed again at the GPT2 geometry; the share of
               coordinates whose first r // 2 + 1 rows all square under
               the timed threshold, and of 8-position sectors all of
               whose coordinates do (plain torch on the card); K4 (the
               flash-attention forward) against its plain version on
               the main path's layout, the [16, 12, L, 64] head views
               of one fused [16, L, 3 * 768] QKV projection, for the
               main path's L, 294, 256, 300 and 1024, within K4_RTOL.
               Times as in phase 3, K4's on those views; its library
               yardstick is scaled_dot_product_attention (f32, causal)
               pinned to the memory-efficient backend, on the same
               views, and its bound counts the products at the TF32
               tensor-core rate in three passes.
7. gpt2     — the port's gpt2_train.train_gpt2() on the full-width
               GPT2-small (D = 124,444,417, HashTokenizer(50262)),
               BASELINE config #5 (`--mode sketch --error_type virtual
               --virtual_momentum 0.9 --local_momentum 0 --num_workers 8`,
               k, r, c at their defaults) with `--max_history 20` over a
               synthetic PersonaChat of 16 personas x 2 dialogs x 24
               utterances (L = 299), 8 clients x 8 examples a round,
               GPT2_ROUNDS rounds. Every loss finite, the weights moved,
               K3a and K3b once a round, K1 twice (the cohort sum and the
               re-encode of the update), K4 12 x 8 a round. Then
               gpt2_train.test_gpt2 on the val split (forward only,
               through K4): its NLL finite.
8. gparity  — one round's gradient sum, table and threshold selection
               of a 2-layer full-width GPT2 (d = 53,565,697, so the
               threshold route), 2 clients x 2 examples at L = 299, on
               the card and on the CPU, beside a float64 CPU gradient:
               phase 5's checks at this model's own tolerances
               (GPT2_PARITY_RTOL, GPT2_ACCURACY_FLOOR), the selections
               sharing >= 99%; and a control run of the card with TF32
               matmuls, which those limits must refuse.

Before the last two lines comes {"kernels": [...]}, one entry per
kernel and main path: K1 twice (sketch_encode at config #2's shapes,
sketch_encode_gpt2 at config #5's), each with the launches of its own
path's run ("path"). The line before the last holds the card's name
and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
`--profile [DIR]` additionally traces three more rounds of each path
with torch.profiler and writes the device time by kernel to
DIR/profile_rounds.txt (config #2) and DIR/profile_gpt2_rounds.txt
(config #5), chiprun_out/ beside the script by default, and prints
K3b's mean device time a launch on the GPT2 rounds' own tables.
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

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, float32 outside
# the tensor cores, and dense TF32 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12

MAIN_D, MAIN_C, MAIN_R = 6_568_640, 500_000, 5
SMALL_GEOMETRIES = [
    dict(d=1000, c=200, r=5),       # padded tail, odd r
    dict(d=512, c=128, r=4),        # exact fit, even r
    dict(d=300, c=400, r=3),        # single chunk, c > d
    dict(d=5000, c=301, r=5),       # c % 4 != 0, ragged last chunk
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

# the GPT2 path (BASELINE config #5)
GPT2_D, GPT2_VOCAB = 124_444_417, 50262
GPT2_CORPUS = (16, 2, 24)    # personas, dialogs each, utterances each
GPT2_L = 299                 # the corpus's padded train length
GPT2_ROUNDS = 6              # of 12 an epoch (768 examples / (8 x 8))
CONFIG5 = ["--dataset_name", "PERSONA", "--mode", "sketch",
           "--error_type", "virtual", "--virtual_momentum", "0.9",
           "--local_momentum", "0", "--num_workers", "8",
           "--max_history", "20"]
# K3 geometries of tests/test_kernels.py:112-160 as (geometry, stride,
# ns): the heavy-hitter and dispatch geometries at their own sample
# geometry, and the chunk narrower than the stride (clamped to c, one
# sample a chunk)
K3_GEOMETRIES = [(dict(d=40000, c=10000, r=5), None),
                 (dict(d=20000, c=5000, r=5), None),
                 (dict(d=16384, c=256, r=5), (256, 1))]
# K3b is held at three thresholds a geometry: the main path's share of
# coordinates kept (k = 50,000 of GPT2_D, as the sample's quantile), the
# median of the sample squares (about half kept) and the square of a
# value the median keeps (a tie, which >= keeps)
K3_THRESHOLDS = ("main-path", "median", "tie")
MAIN_KEEP = 50_000 / GPT2_D
# K4 against its plain version: the kernel's 3xTF32 tensor-core
# products over 64-key tiles (f32-accurate to ~2^-22 a product) vs the
# plain f32 128-key-block fold, reductions in another order
K4_RTOL = 1e-5
K4_LENGTHS = (GPT2_L, 294, 256, 300, 1024)
# the main path's attention operands: GPT2-small's fused QKV projection
# of 16 sequences (8 clients x 2 candidates), 12 heads of 64
K4_BATCH, K4_HEADS, K4_DH = 16, 12, 64
# GPT2 card-vs-CPU tolerances, its own: the 2-layer GPT2's float32
# gradient sits about 2e-6 (relative L2) from float64 on either device,
# three orders below ResNet9's, so ResNet9's limits would let the card
# be ~100x less accurate than the CPU. These sit ~10x above those
# readings and below the error of the same round with TF32 matmuls
# (the control run of phase 8, which they must refuse).
GPT2_PARITY_RTOL = 2e-5
GPT2_ACCURACY_FLOOR = 1e-5


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """Registers, spill bytes and static shared memory of K1, K2, K3a
    and K3b at r = 5 and r = 16 and of K4 at each Dh
    from the build's `-Xptxas -v` report (empty when the library was
    already built). K4's tiles are dynamic shared memory, printed beside
    it."""
    import re
    out, fn = [], None
    names = (("encode_rows_kernelILi5E", "encode_rows_kernel<5>"),
             ("encode_rows_kernelILi16E", "encode_rows_kernel<16>"),
             ("estimate_all_kernelILi5E", "estimate_all_kernel<5>"),
             ("estimate_all_kernelILi16E", "estimate_all_kernel<16>"),
             ("threshold_sample_kernelILi5E", "threshold_sample_kernel<5>"),
             ("threshold_sample_kernelILi16E",
              "threshold_sample_kernel<16>"),
             ("threshold_mask_kernelILi5E", "threshold_mask_kernel<5>"),
             ("threshold_mask_kernelILi16E", "threshold_mask_kernel<16>"),
             ("flash_fwd_mma_kernelILi16E", "flash_fwd_mma_kernel<16>"),
             ("flash_fwd_mma_kernelILi32E", "flash_fwd_mma_kernel<32>"),
             ("flash_fwd_mma_kernelILi64E", "flash_fwd_mma_kernel<64>"))
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = next((label for key, label in names if key in m.group(1)),
                      None)
            continue
        if fn and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        if fn and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{fn}: {regs} registers, {spill} bytes spilled, "
                       f"{smem.group(1) if smem else 0} bytes static smem")
            fn = None
    return "; ".join(out)


def k4_smem_bytes(dh: int) -> int:
    """flash_fwd_mma_kernel's dynamic shared memory a block (flash_fwd.cu
    `Tile`): K and V tiles of 64 rows of Dh + 4 floats, 3 stages."""
    return 4 * 2 * 3 * 64 * (dh + 4)


def time_cuda(fn, iters: int, warmup: int = 3, flush: bool = True,
              wait: bool = True) -> float:
    """Median ms of `fn` over `iters` launches, CUDA events around each,
    the 50 MB L2 overwritten before each (the round finds its inputs
    cold: they are written by other kernels in between). With `wait`, a
    0.2 ms device-side wait before the first event keeps the card busy
    while the host enqueues the event and `fn`'s launches, so the time
    is the device's and not the host's launch overhead (a wrapper's
    Python checks take some tens of microseconds). Without it the card
    has only the flush to run while the host enqueues, so the reading
    also holds the wrapper's host time beyond the flush's ~30 us."""
    scratch = torch.empty(96 * 2 ** 20 // 4, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        if flush:
            scratch.zero_()
        if wait:
            torch.cuda._sleep(400_000)      # ~0.2 ms at the H100's clock
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
        eps_bits, delta_bits = sk.sign_bits(dev)
        g = torch.Generator().manual_seed(geom["d"])
        x = torch.randn(geom["d"], generator=g).to(dev)
        t_k = sk.encode(x)
        t_p = sc.encode_plain(x, off, delta, eps, sk.c)
        e_k = sc.estimate_all(t_k, off, delta_bits, eps_bits, sk.d)
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
    eps_bits, delta_bits = sk.sign_bits(dev)
    x = torch.randn(d, generator=torch.Generator().manual_seed(1)).to(dev)
    table = sk.encode(x)
    rows = [encode_row(sc, sk, x, "sketch_encode", "config2")]
    # K2: read the table, off and the sign bits of eps [r, c] and delta
    # [r, B] once; write the [B, c] estimate once. Operations per
    # estimate: 2r sign flips, the r(r-1)/2 compare-exchanges (2 each),
    # the middle.
    k2_bytes = (4 * r * c + bits_bytes(r * c) + 4 * r * B
                + bits_bytes(r * B) + 4 * B * c)
    k2_ops = B * c * (2 * r + r * (r - 1) + 2)
    rows.append(dict(
        name="sketch_estimate_all", counter="sketch_estimate_all",
        path="config2", route="cuda",
        source="commefficient_tpu_torch/ops/csrc/sketch.cu",
        replaces="commefficient_tpu/ops/kernels/sketch_pallas.py:191",
        fn=lambda: sc.estimate_all(table, off, delta_bits, eps_bits, d),
        plain=lambda: sc.estimate_all_plain(table, off, delta, eps, d),
        library=None, bytes=k2_bytes, ops=k2_ops))
    out = [timed_row(row, max_err[row["counter"]]) for row in rows]
    phase("kernels", "sketch_estimate_all store policy: plain write-back "
          "float4 stores (not K3b's streaming __stcs: the [B, c] output "
          "and the table fit in the L2 together; sketch.cu header)")
    return out


def bits_bytes(n: int) -> int:
    """Bytes of the int32 words that hold n packed sign bits: the form
    in which K1, K3a and K3b read the +-1 tables eps and delta."""
    return 4 * -(-n // 32)


def k1_bytes(d: int, r: int, c: int, B: int) -> int:
    """K1 reads x, off [r, B] and the sign bits of eps [r, c] and delta
    [r, B] once and writes the [r, c] table once."""
    return 4 * d + 4 * r * B + bits_bytes(r * c) + bits_bytes(r * B) \
        + 4 * r * c


def encode_row(sc, sk, x, name, path):
    """The K1 row at `sk`'s geometry on `x` (on the card). Operations:
    r * d * (2 multiplies + 1 add) in f32. Library yardstick: one
    index_add_ of the pre-hashed, pre-signed [r * d] values into the
    flat table (hash and signs precomputed, not timed)."""
    d, c, r = sk.d, sk.c, sk.r
    off, eps, delta = sk.tables(x.device)
    eps_bits, delta_bits = sk.sign_bits(x.device)
    buckets, signs = sk.hash_indices(torch.arange(d, device=x.device))
    flat_pos = (torch.arange(r, device=x.device)[:, None] * c
                + buckets).reshape(-1)
    del buckets
    src = (signs * x[None, :]).reshape(-1)
    del signs
    lib_out = torch.zeros(r * c, device=x.device)
    return dict(
        name=name, counter="sketch_encode", path=path, route="cuda",
        source="commefficient_tpu_torch/ops/csrc/sketch.cu",
        replaces="commefficient_tpu/ops/kernels/sketch_pallas.py:146",
        fn=lambda: sc.encode(x, off, delta_bits, eps_bits, c),
        plain=lambda: sc.encode_plain(x, off, delta, eps, c),
        library=lambda: lib_out.zero_().index_add_(0, flat_pos, src),
        bytes=k1_bytes(d, r, c, sk.n_chunks), ops=3 * r * d)


def timed_row(row, max_abs_err):
    """One entry of the kernels line: the kernel's, its plain version's
    and the library call's median times, and the bound from the bytes
    and operations the work needs (PEAK_*: the operations at the row's
    `peak_flops`, f32 outside the tensor cores unless it says
    otherwise). `ms` is the kernel's device time; `host_ms` times the
    same wrapper call with no device-side wait, so it also holds the
    wrapper's host time beyond the L2 flush. `counter` names the launch
    counter and `path` the main path whose count the entry takes."""
    t_bytes = row["bytes"] / PEAK_BYTES_PER_S * 1e3
    t_ops = row["ops"] / row.get("peak_flops", PEAK_F32_FLOPS) * 1e3
    res = dict(
        name=row["name"], counter=row["counter"], path=row["path"],
        route=row["route"], source=row["source"],
        replaces=row["replaces"], launches=0, max_abs_err=max_abs_err,
        ms=time_cuda(row["fn"], 50),
        host_ms=time_cuda(row["fn"], 50, wait=False),
        plain_ms=time_cuda(row["plain"], 5, warmup=1),
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=(None if row["library"] is None
                    else time_cuda(row["library"], 20)))
    phase("kernels", f"{res['name']}: kernel_ms={res['ms']:.4f} "
          f"host_ms={res['host_ms']:.4f} "
          f"plain_ms={res['plain_ms']:.4f} bound_ms="
          f"{res['bound_ms']:.4f} ({res['bound_by']}) library_ms="
          f"{res['library_ms']}")
    return res


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


def reset_counts(sc, ac) -> None:
    sc.reset_launches()
    ac.reset_launches()


def read_counts(sc, ac) -> dict:
    return {**sc.LAUNCHES, **ac.LAUNCHES}


def main_path(sc, ac, cv_train, parse_args, data_dir):
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
    reset_counts(sc, ac)
    t0 = time.perf_counter()
    timed = TimedLoader(train_loader)
    ok = cv_train.train(model, opt, sched, timed, val_loader,
                        model.cfg, on_round=on_round)
    torch.cuda.synchronize()
    launches = read_counts(sc, ac)
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


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


def parity_phase(label, build, w, data, mask, cfg, make_loss, rtol, floor,
                 fclient, fserver, flat, tf32_control=False):
    """One round's client gradient sum, sketch table and server selection
    (top-k, or the threshold route's) on the card vs the CPU, from the
    same flat weights `w` and batch (`data` numpy arrays, floating ones
    cast to the run's dtype), with a float64 CPU gradient as the
    yardstick of float32 rounding. `build()` makes a fresh module and
    `make_loss(module)` its loss. It passes when card and CPU agree
    within `rtol`, the card lies within ACCURACY_RATIO x max(the CPU's
    float32 error, `floor`) of float64, and the selections share
    TOPK_OVERLAP of theirs. With `tf32_control` the card runs the round
    once more with TF32 matmuls and convolutions: the gradient limits
    must refuse that run, or they could not tell TF32 from float32."""
    sketch = fserver.args2sketch(cfg)
    runs = [("cuda", torch.float32, False), ("cpu", torch.float32, False),
            ("cpu", torch.float64, False)]
    if tf32_control:
        runs.append(("cuda", torch.float32, True))
    tf32_flags = (torch.backends.cuda.matmul.allow_tf32,
                  torch.backends.cudnn.allow_tf32)
    out = {}
    for dev, dtype, tf32 in runs:
        module = build().to(dev, dtype)
        _, unravel = flat.flatten_params(module)
        loss = fclient.make_flat_loss_fn(make_loss(module), unravel)
        xs = tuple(t.to(dtype) if t.is_floating_point() else t
                   for t in (torch.from_numpy(a).to(dev) for a in data))
        m = torch.from_numpy(mask).to(dev, dtype)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            g, _, _, counts = fclient.fused_shard_grads(
                loss, w.detach().to(dev, dtype), xs, m, cfg)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32_flags
        key = "f64" if dtype == torch.float64 else "tf32" if tf32 else dev
        if key != "f64":
            table = sketch.encode(g) / counts.sum()
            zeros = torch.zeros(sketch.table_shape, device=dev)
            upd = fserver.get_server_update(table, zeros, zeros, cfg, 1.0)
            top = set(torch.nonzero(upd.update).reshape(-1).cpu().tolist())
            out[key] = (g.cpu(), table.cpu(), top)
            del table, upd
        else:
            out[key] = g.cpu()
        del module, g
    (gc, tc, kc), (gp, tp, kp), g64 = out["cuda"], out["cpu"], out["f64"]
    g_err, t_err = _rel(gc, gp), _rel(tc, tp)
    card64, cpu64 = _rel(gc, g64), _rel(gp, g64)
    overlap = len(kc & kp) / max(len(kp), 1)
    accuracy_limit = ACCURACY_RATIO * max(cpu64, floor)
    phase(label, f"card vs CPU: grad rel err {g_err:.3e}, table rel "
          f"err {t_err:.3e} (tolerance {rtol:g}); vs the float64 CPU "
          f"gradient: card {card64:.3e}, CPU float32 {cpu64:.3e} (card <= "
          f"{ACCURACY_RATIO:g} x max(CPU, {floor:g})); selection overlap "
          f"{overlap:.5f} of {len(kp)} (card selected {len(kc)}; >= "
          f"{TOPK_OVERLAP:g})")
    if not (g_err <= rtol and t_err <= rtol and card64 <= accuracy_limit
            and overlap >= TOPK_OVERLAP):
        raise AssertionError("card and CPU disagree beyond tolerance")
    if tf32_control:
        gt = out["tf32"][0]
        tf_err, tf64 = _rel(gt, gp), _rel(gt, g64)
        phase(label, f"control, the card with TF32: grad rel err vs CPU "
              f"{tf_err:.3e}, vs float64 {tf64:.3e} (must exceed {rtol:g} "
              f"or {accuracy_limit:.3e})")
        if tf_err <= rtol and tf64 <= accuracy_limit:
            raise AssertionError("the limits pass a TF32 round: they cannot "
                                 "tell TF32 from float32")
    return g_err, t_err, overlap


def kernel_phase_gpt2(sc, ac, CSVec):
    """K1 at the GPT2 geometry, K3a / K3b / K4 against their plain
    versions; returns their result rows (launch counts filled in after
    the GPT2 main path)."""
    dev = torch.device("cuda")
    err = {"sketch_encode": 0.0, "threshold_sample": 0.0,
           "threshold_mask": 0.0, "flash_fwd": 0.0}
    for geom, sampling in (K3_GEOMETRIES
                           + [(g, None) for g in SMALL_GEOMETRIES]
                           + [(dict(d=GPT2_D, c=MAIN_C, r=MAIN_R), None)]):
        sk = CSVec(**geom)
        off, eps, delta = sk.tables(dev)
        eps_bits, delta_bits = sk.sign_bits(dev)
        g = torch.Generator().manual_seed(geom["d"] + 1)
        x = torch.randn(geom["d"], generator=g).to(dev)
        table = sk.encode(x)
        t_p = sc.encode_plain(x, off, delta, eps, sk.c)
        stride, ns = sampling or sc.threshold_sample_geometry(sk.n_chunks,
                                                              sk.c)
        s_k = sc.threshold_sample(table, off, delta_bits, eps_bits, sk.d,
                                  stride, ns)
        s_p = sc.threshold_sample_plain(table, off, delta, eps, sk.d, stride,
                                        ns)
        pairs = [("sketch_encode", "", table, t_p),
                 ("threshold_sample", "", s_k, s_p)]
        selected = []
        for label, thr in zip(K3_THRESHOLDS, k3_thresholds(
                sc, s_p, table, off, delta, eps, sk.d)):
            m_k = sc.threshold_mask(table, off, delta_bits, eps_bits, thr,
                                    sk.d)
            m_p = sc.threshold_mask_plain(table, off, delta, eps, thr, sk.d)
            selected.append(int((m_p != 0).sum()))
            pairs.append(("threshold_mask", f" at the {label} threshold",
                          m_k, m_p))
        torch.cuda.synchronize()
        for name, where, k, p in pairs:
            e = float((k - p).abs().max())
            err[name] = max(err[name], e)
            if not torch.equal(k, p):
                raise AssertionError(f"{name} differs from its plain "
                                     f"version at {geom}{where}: max abs "
                                     f"err {e}")
        phase("kernels", f"{geom}: K1, K3a and K3b equal to their plain "
              f"versions (exact; stride {stride}, {ns} samples a chunk; "
              "selected at the " + ", ".join(
                  f"{t} threshold {n}" for t, n in zip(K3_THRESHOLDS,
                                                       selected)) + ")")
        del x, table, t_p, s_k, s_p, m_k, m_p, pairs
    shape = f"[{K4_BATCH}, {K4_HEADS}, L, {K4_DH}]"
    for L in K4_LENGTHS:
        q, k, v = k4_operands(L, seed=L)
        o, lse = ac.flash_fwd(q, k, v, 0.125)
        po, plse = ac.flash_fwd_plain(q, k, v, 0.125)
        torch.cuda.synchronize()
        e_o = float((o - po).abs().max())
        e_l = float((lse - plse).abs().max())
        err["flash_fwd"] = max(err["flash_fwd"], e_o, e_l)
        if not (e_o <= K4_RTOL * float(po.abs().max())
                and e_l <= K4_RTOL * float(plse.abs().max())):
            raise AssertionError(f"flash_fwd differs from its plain version "
                                 f"at {shape}, L={L}: o {e_o}, lse {e_l}")
        phase("kernels", f"{shape}, L={L}, head views of the fused QKV "
              f"projection: K4 within {K4_RTOL:g} of its plain version "
              f"(max abs err o {e_o:.3e}, lse {e_l:.3e})")
        del q, k, v, o, lse, po, plse

    # timing at the GPT2 main-path shapes
    d, c, r = GPT2_D, MAIN_C, MAIN_R
    sk = CSVec(d=d, c=c, r=r)
    B = sk.n_chunks
    off, eps, delta = sk.tables(dev)
    eps_bits, delta_bits = sk.sign_bits(dev)
    x = torch.randn(d, generator=torch.Generator().manual_seed(2)).to(dev)
    table = sk.encode(x)
    stride, ns = sc.threshold_sample_geometry(B, c)
    sample = sc.threshold_sample(table, off, delta_bits, eps_bits, d, stride,
                                 ns)
    thr = (sample.reshape(-1) ** 2).quantile(1 - MAIN_KEEP).reshape(1)
    early_out_shares(sk, table, off, thr)
    # operations per estimate: 2r multiplies, r(r-1)/2 compare-exchanges
    # (2 each), the middle; K3b adds the square and the compare
    est_ops = 2 * r + r * (r - 1) + 2
    q, kk, v = k4_operands(GPT2_L, seed=3)
    bh = K4_BATCH * K4_HEADS
    pairs = bh * GPT2_L * (GPT2_L + 1) // 2      # causal (q, k) pairs
    sdpa = sdpa_efficient(ac, q, kk, v)
    rows = [
        encode_row(sc, sk, x, "sketch_encode_gpt2", "config5"),
        # K3a reads the whole table (its r * B * ns gathers cover it),
        # the sign bits of eps at the r * ns sampled positions and of
        # delta [r, B], off once, and writes the [B, ns] sample once
        dict(name="threshold_sample", counter="threshold_sample",
             path="config5", route="cuda",
             source="commefficient_tpu_torch/ops/csrc/sketch.cu",
             replaces="commefficient_tpu/ops/kernels/sketch_pallas.py:232",
             fn=lambda: sc.threshold_sample(table, off, delta_bits, eps_bits,
                                            d, stride, ns),
             plain=lambda: sc.threshold_sample_plain(table, off, delta, eps,
                                                     d, stride, ns),
             library=None,
             bytes=4 * r * c + bits_bytes(r * ns) + 4 * r * B
             + bits_bytes(r * B) + 4 * B * ns,
             ops=B * ns * est_ops),
        # K3b reads the table, off, the sign bits of eps and delta and
        # the threshold once, and writes the [d] output once
        dict(name="threshold_mask", counter="threshold_mask",
             path="config5", route="cuda",
             source="commefficient_tpu_torch/ops/csrc/sketch.cu",
             replaces="commefficient_tpu/ops/kernels/sketch_pallas.py:250",
             fn=lambda: sc.threshold_mask(table, off, delta_bits, eps_bits,
                                          thr, d),
             plain=lambda: sc.threshold_mask_plain(table, off, delta, eps,
                                                   thr, d),
             library=None,
             bytes=4 * r * c + 4 * r * B + bits_bytes(r * c)
             + bits_bytes(r * B) + 4 + 4 * d,
             ops=d * (est_ops + 2)),
        # q, k, v (the fused projection) read once, o and lse written
        # once; 4 Dh operations (the score and the PV product) for each
        # causal pair, f32-accurate, so on the TF32 tensor cores in
        # three passes: 3x the operations at the TF32 rate (the route
        # SDPA's own f32 kernel takes too), against which the bytes are
        # the bound
        dict(name="flash_fwd", counter="flash_fwd", path="config5",
             route="cuda",
             source="commefficient_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces="commefficient_tpu/ops/attention.py:91",
             fn=lambda: ac.flash_fwd(q, kk, v, 0.125),
             plain=lambda: ac.flash_fwd_plain(q, kk, v, 0.125),
             library=sdpa,
             bytes=4 * 4 * q.numel() + 4 * bh * GPT2_L,
             ops=3 * 4 * K4_DH * pairs, peak_flops=PEAK_TF32_FLOPS),
    ]
    return [timed_row(row, err[row["counter"]]) for row in rows]


def k3_thresholds(sc, sample, table, off, delta, eps, d):
    """K3b's thresholds at one geometry, in K3_THRESHOLDS' order, from
    the plain sample and the plain mask."""
    sq = (sample * sample).reshape(-1)
    main = sq.quantile(1 - MAIN_KEEP).reshape(1)
    median = sq.median().reshape(1)
    kept = sc.threshold_mask_plain(table, off, delta, eps, median, d)
    kept = kept[kept != 0]
    tie = (kept[kept.numel() // 2] ** 2).reshape(1)
    return main, median, tie


def early_out_shares(sk, table, off, thr) -> None:
    """Print the share of coordinates whose first m = r // 2 + 1 row
    values all square under `thr`, and of 8-position sectors (32 bytes
    of the output; their table reads share sectors too) all of whose
    coordinates do: what an early-out of K3b after m rows would skip.
    Plain torch on the card, from the same table (the signs do not
    change a square)."""
    d, c, B = sk.d, sk.c, sk.n_chunks
    pos = torch.arange(c, device=table.device)
    small = torch.ones(B, c, dtype=torch.bool, device=table.device)
    for j in range(sk.r // 2 + 1):
        v = table[j][(pos[None, :] + off[j][:, None].long()) % c]
        small &= v * v < thr
        del v
    # the tail (and any padding to whole sectors) needs no rows
    small = torch.cat([small.reshape(-1),
                       small.new_ones(-(-B * c // 8) * 8 - B * c)])
    small[d:] = True
    coords = float(small[:d].float().mean())
    sectors = float(small.reshape(-1, 8).all(dim=1)[:-(-d // 8)]
                    .float().mean())
    phase("kernels", f"at d={d}, r={sk.r} and the timed threshold: "
          f"{coords:.4f} of the coordinates have their first "
          f"{sk.r // 2 + 1} rows all under it, and {sectors:.4f} of the "
          "8-position sectors hold only such coordinates (plain torch)")


def k4_operands(L: int, seed: int):
    """q, k, v as the GPT2 main path hands them to K4: the [B, H, L, Dh]
    head views of one fused [K4_BATCH, L, 3 * 768] QKV projection (row
    stride 3 * 768, no copy)."""
    E = K4_HEADS * K4_DH
    qkv = torch.randn(K4_BATCH, L, 3 * E,
                      generator=torch.Generator().manual_seed(seed)
                      ).to("cuda")
    return tuple(t.reshape(K4_BATCH, L, K4_HEADS, K4_DH).transpose(1, 2)
                 for t in qkv.split(E, dim=-1))


def sdpa_efficient(ac, q, k, v):
    """K4's library yardstick: scaled_dot_product_attention (f32,
    causal) pinned to the memory-efficient backend, on the same views;
    checked once against the plain version so the yardstick computes
    the same function."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call():
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  scale=0.125)
    o = call()
    po, _ = ac.flash_fwd_plain(q, k, v, 0.125)
    e = float((o - po).abs().max() / po.abs().max())
    phase("kernels", f"library yardstick: scaled_dot_product_attention, "
          f"backend {SDPBackend.EFFICIENT_ATTENTION.name} (pinned), on "
          f"the head views; relative max err vs the plain version {e:.3e}")
    if not e <= K4_RTOL:
        raise AssertionError("the SDPA yardstick does not compute K4's "
                             "function")
    return call


def gpt2_main_path(sc, ac, gpt2_train, parse_args, HashTokenizer, data_dir,
                   profile_dir=None):
    """Drive gpt2_train.train_gpt2() for GPT2_ROUNDS rounds of config #5,
    then test_gpt2 on the val split (and, with `profile_dir`, trace
    three more rounds); returns (launches, round ms, peak bytes, a batch
    for parity, the config)."""
    spe = math.ceil(GPT2_CORPUS[0] * GPT2_CORPUS[1] * GPT2_CORPUS[2]
                    / (8 * 8))
    cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR, argv=CONFIG5 + [
        "--local_batch_size", "8", "--device", "cuda",
        "--dataset_dir", data_dir, "--num_epochs", str(GPT2_ROUNDS / spe),
        "--seed", "21"])
    t0 = time.perf_counter()
    model, opt, sched, train_loader, val_loader = gpt2_train.build(
        cfg, HashTokenizer(GPT2_VOCAB), device="cuda",
        synthetic_examples=GPT2_CORPUS)
    phase("gpt2", f"built in {time.perf_counter() - t0:.2f} s: D="
          f"{model.cfg.grad_size}, train L={train_loader.dataset.seq_len}, "
          f"val L={val_loader.dataset.seq_len}, {spe} rounds an epoch")
    assert model.cfg.grad_size == GPT2_D, model.cfg.grad_size
    assert train_loader.dataset.seq_len == GPT2_L
    assert train_loader.steps_per_epoch == spe
    assert model.cfg.fused_client_backward
    w0 = model.ps_weights.clone()
    stamps, losses = [], []

    def on_round(i, out):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(out[0])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timed = TimedLoader(train_loader)
    reset_counts(sc, ac)
    t0 = time.perf_counter()
    ok = gpt2_train.train_gpt2(model, opt, sched, timed, model.cfg,
                               on_round=on_round)
    torch.cuda.synchronize()
    launches = read_counts(sc, ac)
    peak = torch.cuda.max_memory_allocated()
    if not ok:
        raise AssertionError("train_gpt2() reported a NaN/divergent loss")
    if len(stamps) != GPT2_ROUNDS:
        raise AssertionError(f"{len(stamps)} rounds ran, {GPT2_ROUNDS} "
                             "expected")
    loss_vals = torch.stack(losses).cpu()
    if not torch.isfinite(loss_vals).all():
        raise AssertionError(f"non-finite losses: {loss_vals}")
    if torch.equal(model.ps_weights, w0):
        raise AssertionError("the weights did not move")
    want = {"threshold_sample": GPT2_ROUNDS, "threshold_mask": GPT2_ROUNDS,
            "sketch_encode": 2 * GPT2_ROUNDS, "sketch_estimate_all": 0,
            "flash_fwd": 12 * 8 * GPT2_ROUNDS}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {GPT2_ROUNDS} rounds ({n} expected)")
    round_ms = [1e3 * (b - a) for a, b in zip([t0] + stamps[:-1], stamps)]
    phase("gpt2", f"{GPT2_ROUNDS} rounds, D={GPT2_D}, L={GPT2_L}, mean "
          f"client loss first/last {float(loss_vals[0].mean()):.4f}/"
          f"{float(loss_vals[-1].mean()):.4f}, launches {launches}")
    phase("gpt2", "ms/round " + " ".join(f"{t:.2f}" for t in round_ms)
          + f"; median (rounds 2-{GPT2_ROUNDS}) "
          f"{statistics.median(round_ms[1:]):.2f}, of which the host "
          f"makes the batch (data) "
          f"{1e3 * statistics.median(timed.seconds[1:GPT2_ROUNDS]):.2f}; "
          f"peak memory {peak / 2 ** 30:.3f} GiB (max_memory_allocated)")
    reset_counts(sc, ac)
    t0 = time.perf_counter()
    stats = gpt2_train.test_gpt2(model, val_loader)
    torch.cuda.synchronize()
    if not math.isfinite(stats["val_nll"]):
        raise AssertionError(f"non-finite val NLL {stats['val_nll']}")
    phase("gpt2", f"test_gpt2: val NLL {stats['val_nll']:.4f}, acc "
          f"{stats['val_acc']:.4f}, ppl {stats['val_ppl']:.2f} in "
          f"{time.perf_counter() - t0:.2f} s, K4 launched "
          f"{ac.LAUNCHES['flash_fwd']} times")
    if ac.LAUNCHES["flash_fwd"] == 0:
        raise AssertionError("test_gpt2 did not launch K4")
    if profile_dir:
        profile_rounds(model, train_loader, opt,
                       os.path.join(profile_dir, "profile_gpt2_rounds.txt"),
                       "gpt2 profile", per_launch=("threshold_mask_kernel",))
    batch = next(iter(train_loader.epoch()))
    cfg = model.cfg
    del model, opt, sched, w0
    torch.cuda.empty_cache()
    return launches, round_ms, peak, batch, cfg


def profile_rounds(model, train_loader, opt, path, label="profile",
                   per_launch=()):
    """Device time by kernel over three traced rounds (after one
    untraced and one warm-up round of the profiler's schedule); for each
    kernel whose name holds a string of `per_launch`, its mean device
    time a launch."""
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
    phase(label, f"3 traced rounds: wall {wall_ms:.2f} ms, kernels on "
          f"the device {dev_us / 1e3:.2f} ms (busy share "
          f"{dev_us / 1e3 / wall_ms:.3f}); table in {path}")
    for name in per_launch:
        hits = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and name in e.key]
        n = sum(e.count for e in hits)
        if n == 0:
            raise AssertionError(f"no {name} launch in the traced rounds")
        us = sum(e.self_device_time_total for e in hits)
        phase(label, f"{name} on the rounds' own tables: "
              f"{us / 1e3 / n:.4f} ms a launch (device time, mean of {n})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", nargs="?", metavar="DIR", default=None,
                    const=os.path.join(HERE, "chiprun_out"),
                    help="trace three more rounds of each path with "
                         "torch.profiler and write profile_rounds.txt and "
                         "profile_gpt2_rounds.txt into DIR (default "
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
    from commefficient_tpu_torch.data.persona import HashTokenizer
    from commefficient_tpu_torch.federated import server as fserver
    from commefficient_tpu_torch.models import convert
    from commefficient_tpu_torch.models import gpt2 as gpt2_model
    from commefficient_tpu_torch.ops import flat
    from commefficient_tpu_torch.ops.kernels import _build
    from commefficient_tpu_torch.ops.kernels import attention_cuda as ac
    from commefficient_tpu_torch.ops.kernels import sketch_cuda as sc
    from commefficient_tpu_torch.ops.sketch import CSVec
    from commefficient_tpu_torch.training import cv_train, gpt2_train

    resolve_device("cuda")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    phase("device", f"{kind}; nvidia-smi name, power.limit: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.build()
    ptxas = ptxas_summary("\n".join(_build.BUILD_LOG.values()))
    phase("build", f"nvcc sm_90a build of {sorted(_build.SOURCES)} in "
          f"{time.perf_counter() - t0:.2f} s (0 when already built); "
          f"ptxas: {ptxas}; flash_fwd_mma_kernel dynamic smem a block: "
          + ", ".join(f"Dh {dh}: {k4_smem_bytes(dh)} bytes"
                      for dh in ac.SUPPORTED_DH))

    kernels = kernel_phase(sc, CSVec)
    data_dir = os.path.join(HERE, "build", "chip_smoke_data")
    model, round_ms, peak, launches, batch = main_path(
        sc, ac, cv_train, parse_args, data_dir)
    w = model.ps_weights.detach().cpu()

    def build_resnet9():
        module = models.build_model("ResNet9", num_classes=10)
        convert.load_flat(module, w)
        return module

    parity_phase("parity", build_resnet9, w, batch[1], batch[2], model.cfg,
                 cv_train.make_compute_loss, PARITY_RTOL, ACCURACY_FLOOR,
                 fclient, fserver, flat)
    if args.profile:
        profile_rounds(model, cv_train.get_data_loaders(
            model.cfg, (CLIENTS * EXAMPLES_PER_CLIENT, 512))[0],
            model._optimizer, os.path.join(args.profile,
                                           "profile_rounds.txt"))
    del model
    torch.cuda.empty_cache()

    g_kernels = kernel_phase_gpt2(sc, ac, CSVec)
    g_launches, _, _, g_batch, g_cfg = gpt2_main_path(
        sc, ac, gpt2_train, parse_args, HashTokenizer,
        os.path.join(HERE, "build", "chip_smoke_gpt2_data"), args.profile)

    # a 2-layer full-width GPT2 (threshold route), 2 clients x 2
    # examples of a main-path batch
    gcfg = gpt2_model.PRESETS["gpt2"].replace(vocab_size=GPT2_VOCAB,
                                              n_layer=2)
    g_w, _ = flat.flatten_params(gpt2_model.GPT2DoubleHeads(gcfg, seed=5))
    g_cfg = g_cfg.replace(grad_size=int(g_w.shape[0]), num_workers=2)
    assert fserver.args2sketch(g_cfg)._threshold_decode, g_cfg.grad_size
    phase("gparity", f"2-layer GPT2, d={g_cfg.grad_size}, "
          f"L={g_batch[1][0].shape[-1]}, 2 clients x 2 examples")
    parity_phase("gparity",
                 lambda: gpt2_model.GPT2DoubleHeads(gcfg, seed=5), g_w,
                 tuple(a[:2, :2] for a in g_batch[1]), g_batch[2][:2, :2],
                 g_cfg,
                 lambda m: gpt2_train.make_compute_loss_train(m, g_cfg),
                 GPT2_PARITY_RTOL, GPT2_ACCURACY_FLOOR, fclient, fserver,
                 flat, tf32_control=True)
    # launches: each entry's count from its own main path's run
    for k in kernels:
        k["launches"] = launches[k.pop("counter")]
    for k in g_kernels:
        k["launches"] = g_launches[k.pop("counter")]
    kernels += g_kernels

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
