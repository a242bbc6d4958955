"""One run of one cell: set-up, the measured window, the traced
layers, and the comparison with the plain reference.

The entry the window drives is the port's normal GPT2 path:
`config.parse_args` over the configuration's flags,
`training/gpt2_train.build` with the port's `HashTokenizer` over a
PersonaChat file the benchmark writes from the seed, then the rounds
of `gpt2_train.train_gpt2`, ended at the window's close by raising
from its `on_round` callback.

Set-up runs the first rounds through that same call (they are the
rounds the reference follows) and then starts the clock; the window
runs rounds back to back for `seconds` and ends in one synchronize.
The --trace 0 run adds nothing to a round. The --trace 1 run times
the loader's batches, records the port's host spans, and profiles
PROFILED_ROUNDS whole rounds after the window's first; the host
layers and the model step's FLOP rate are read over the window's other
rounds, which the profiler's cost per operation does not slow.

Set-up is timed in phases (`setup_phases`, host clock, seconds from
the process's start): `imports` (the port's modules), `build` (the
corpus written and tokenized, the model, the loaders, the kernels'
load or build), `weights` (drawn on the card from the seed),
`first_round` (the first checked round: the first launch of every
kernel and the libraries' handles) and `checked_rounds` (the rest).
"""
from __future__ import annotations

import gc
import math
import os
import shutil
import tempfile
import time
import types
from typing import List, Optional

import numpy as np
import torch

from portbench import check, corpus, spec
from portbench.reference import gpt2 as ref_gpt2

CHECKED_ROUNDS = 3
PROFILED_ROUNDS = 3


class WindowClosed(Exception):
    """Raised from on_round when the window's time is up."""


class Feed:
    """The train loader as train_gpt2 reads it, keeping the first
    rounds' batches for the comparison and, when `timed`, the host
    seconds of each batch drawn, beside its monotonic start."""

    def __init__(self, inner, keep: int):
        self.inner = inner
        self.keep = keep
        self.kept: list = []
        self.timed = False
        self.seconds: List[float] = []

    @property
    def steps_per_epoch(self):
        return self.inner.steps_per_epoch

    @property
    def sampler(self):
        return self.inner.sampler

    def epoch(self, skip: int = 0):
        it = iter(self.inner.epoch(skip=skip))
        while True:
            if self.timed:
                t, t_mono = time.perf_counter(), time.monotonic()
                with torch.profiler.record_function("portbench.data.next"):
                    item = next(it, None)
                self.seconds.append((t_mono, time.perf_counter() - t))
            else:
                item = next(it, None)
            if item is None:
                return
            if len(self.kept) < self.keep:
                ids, data, mask = item
                self.kept.append((np.array(ids), tuple(np.array(a)
                                                       for a in data),
                                  np.array(mask)))
            yield item


def set_cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port builds its kernels into <checkout>/build itself)."""
    base = os.path.join(root, "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    for name in ("USE_FLAX", "USE_TF"):
        os.environ[name] = "0"
    for name in ("HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE"):
        os.environ[name] = "1"


def program_flags(cell: spec.Cell, seed: int, device: str,
                  data_dir: str) -> list:
    t = cell.traffic
    return list(cell.config["flags"]) + [
        "--num_workers", str(t["clients_per_round"]),
        "--local_batch_size", str(t["examples_per_client"]),
        "--device", device, "--dataset_dir", data_dir,
        "--num_epochs", str(check.SCHEDULE_EPOCHS),
        "--seed", str(seed % 2 ** 31)]


def first_batches(cell: spec.Cell, seed: int, device: str):
    """(raw corpus, the first checked rounds' batches, the weight
    layout) as a run of `seed` draws them, through the port's data layer
    alone: what the lower-precision control needs."""
    from commefficient_tpu_torch.config import parse_args
    from commefficient_tpu_torch.data.persona import HashTokenizer
    from commefficient_tpu_torch.training import gpt2_train
    data_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        raw = corpus.make_raw(cell.traffic["corpus"], seed)
        corpus.write_raw(data_dir, raw)
        cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR,
                         argv=program_flags(cell, seed, device, data_dir))
        loader, _ = gpt2_train.get_data_loaders(
            cfg, HashTokenizer(cell.config["vocab_size"]))
        feed = Feed(loader, CHECKED_ROUNDS)
        it = feed.epoch()
        for _ in range(CHECKED_ROUNDS):
            next(it)
        L = loader.dataset.seq_len
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    c = cell.config
    return raw, feed.kept, ref_gpt2.layout(
        c["n_layer"], c["n_embd"], c["vocab_size"],
        max(c["n_positions"], L))


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: Optional[float] = None, fault=None):
    """One run; returns what the result line and the metric readers
    need. `fault` (tests and calibration only) plants a fault in the
    built program."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = device.startswith("cuda")
    from commefficient_tpu_torch.config import parse_args
    from commefficient_tpu_torch.data.persona import HashTokenizer
    from commefficient_tpu_torch.telemetry.trace import TRACE
    from commefficient_tpu_torch.training import gpt2_train
    from commefficient_tpu_torch.utils.logging import SilentLogger

    phases = {"imports": time.perf_counter() - t_start}
    cfgj, traffic = cell.config, cell.traffic
    data_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        raw = corpus.make_raw(traffic["corpus"], seed)
        corpus.write_raw(data_dir, raw)
        cfg = parse_args(default_lr=gpt2_train.DEFAULT_LR,
                         argv=program_flags(cell, seed, device, data_dir))
        model, opt, sched, loader, _ = gpt2_train.build(
            cfg, HashTokenizer(cfgj["vocab_size"]), device=device)
    finally:
        shutil.rmtree(data_dir, ignore_errors=True)
    L = loader.dataset.seq_len
    leaves = ref_gpt2.layout(cfgj["n_layer"], cfgj["n_embd"],
                             cfgj["vocab_size"],
                             max(cfgj["n_positions"], L))
    D = leaves[-1].offset + leaves[-1].size
    if D != model.cfg.grad_size:
        raise RuntimeError(f"the program has {model.cfg.grad_size} weights, "
                           f"the configuration {D}")
    phases["build"] = time.perf_counter() - t_start
    model.server = model.server._replace(
        ps_weights=ref_gpt2.init_weights(leaves, seed, model.device))
    phases["weights"] = time.perf_counter() - t_start
    undo = fault(model) if fault is not None else None
    feed = Feed(loader, CHECKED_ROUNDS)
    prof = None
    if trace and cuda:
        from portbench import devtrace
        devtrace.Profiler.warm(model.device)
        prof = devtrace.Profiler()

    st = types.SimpleNamespace(
        window=False, rounds=0, losses=[], downloads=[], uploads=[],
        table1=None, deadline=0.0, t0=0.0, t0_mono=0.0, window_losses=[],
        profiled=0, prof_start=None, prof_span=[math.inf, math.inf])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def on_round(i, out):
        if not st.window:
            st.losses.append(out[0].detach().clone())
            st.downloads.append(np.array(out[3], np.float64))
            st.uploads.append(np.array(out[4], np.float64))
            if i == 0:
                phases["first_round"] = time.perf_counter() - t_start
                st.table1 = model.server.Vvelocity.detach().to("cpu")
                st.E1 = model.server.Verror.detach().to("cpu")
                st.w1 = model.ps_weights.detach().to("cpu")
            if i == CHECKED_ROUNDS - 1:
                st.V3 = model.server.Vvelocity.detach().to("cpu")
                st.E3 = model.server.Verror.detach().to("cpu")
                st.w3 = model.ps_weights.detach().to("cpu")
                sync()
                if cuda:
                    torch.cuda.reset_peak_memory_stats()
                if trace:
                    TRACE.enable()
                    feed.timed = True
                st.window = True
                st.t0 = time.perf_counter()
                st.t0_mono = time.monotonic()
                st.setup_s = st.t0 - t_start
                phases["checked_rounds"] = st.setup_s
                st.deadline = st.t0 + seconds
            return
        st.rounds += 1
        st.window_losses.append(out[0])
        if prof is not None:
            if st.rounds == 1:
                prof.start()
                st.prof_start = st.rounds
                st.prof_span = [time.monotonic(), math.inf]
            elif st.prof_start is not None and not st.profiled and (
                    st.rounds - st.prof_start == PROFILED_ROUNDS):
                prof.stop()
                st.profiled = PROFILED_ROUNDS
                st.prof_span[1] = time.monotonic()
        if time.perf_counter() >= st.deadline:
            raise WindowClosed

    ok = True
    try:
        ok = gpt2_train.train_gpt2(model, opt, sched, feed, model.cfg,
                                   logger=SilentLogger(), on_round=on_round)
    except WindowClosed:
        pass
    sync()
    t_end = time.perf_counter()
    t_end_mono = time.monotonic()
    if undo is not None:
        undo()
    if not st.window:
        raise RuntimeError("the run ended before its window opened")
    if prof is not None and st.prof_start is not None and not st.profiled:
        prof.stop()
        st.profiled = st.rounds - st.prof_start
        st.prof_span[1] = time.monotonic()
    r = types.SimpleNamespace(
        cell=cell, config=cfgj, traffic=traffic, seq_len=L, d=D,
        rounds=st.rounds, window_s=t_end - st.t0, setup_s=st.setup_s,
        peak_bytes=torch.cuda.max_memory_allocated() if cuda else 0,
        completed=ok, batch_s=[], spans=[], trace=None,
        profiled_rounds=st.profiled, clients=traffic["clients_per_round"],
        examples=traffic["examples_per_client"],
        candidates=check.flag(cfgj["flags"], "--num_candidates", int),
        num_cols=model.cfg.num_cols, setup_phases=phases)
    r.failed_rounds = int(sum(
        int((~torch.isfinite(x)).any()) for x in st.window_losses))
    # the host-side layers are read over the window's rounds outside the
    # profile, whose per-operation cost would count in them
    lo, hi = st.prof_span
    r.host_rounds = st.rounds - st.profiled
    r.host_window_s = r.window_s - (hi - lo if st.profiled else 0.0)
    if trace:
        r.batch_s = [s for t, s in feed.seconds if not lo <= t <= hi]
        spans, _ = TRACE.drain()
        TRACE.disable()
        r.spans = [s for s in spans if st.t0_mono <= s["t0"] <= t_end_mono
                   and not lo <= s["t0"] <= hi]
        if prof is not None and st.profiled:
            from portbench import devtrace
            r.trace = devtrace.analyze(prof.prof, prof.marks)
        prof = None

    prog = {"batches": feed.kept, "losses": torch.stack(st.losses).cpu(),
            "downloads": st.downloads, "uploads": st.uploads,
            "table1": st.table1, "E1": st.E1, "V": st.V3, "E": st.E3,
            "w1": st.w1, "w": st.w3}
    model_device = model.device
    del model, opt, sched, loader, feed, st
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    r.readings = {}
    r.numbers = check.against_reference(
        cfgj, traffic, raw, prog, seed, leaves, model_device,
        out=r.readings)
    r.reference_s = time.perf_counter() - t_ref
    r.correct, r.checks = check.verdict(r.numbers, cell.limits)
    if not r.completed or r.failed_rounds:
        r.correct = False
    return r
