#!/usr/bin/env python3
"""Phases 27-43 of chip_smoke.py alone on one CUDA card, and the host
timeline of config #4's rounds, for work on the plugins, the span
loop, the scheduler, async admission, the tiered client state, the
controllers, the blockwise decode, the ranks, the plan transport and
the analysis tiers without the whole script:

    python3 scripts/chip_phases.py [powersgd dp_sketch privacy spans
                                    imagenet timeline sched async_admit
                                    statetier control gpt2medium grid
                                    tpgpt2 plan plangrid ring analysis
                                    audit]

With no argument it runs every phase. Phase 4 (config #2) runs first
for the ms/round the new phases print beside theirs, `imagenet` runs
phase 13 before phase 31 and `statetier` phase 11 before phase 34 for
the same reason; `gpt2medium` runs phase 36's kernel checks, then its
rounds (without phase 7 beside them). `grid` runs phase 5 after phase
4 (its reduced table is held to phase 5's), then phase 37's kernel rows
and ranks, whose second and third legs are phases 40-41 (`plangrid`
and `ring` run the same); `tpgpt2` runs K4's 6-head check and phase 38
(without phase 7 beside it); `plan` runs phase 39, `analysis`
phase 42 and `audit` phase 43 after phase 4.
`timeline` drives config #4 (chip_smoke.CONFIG4) plain and each way of
chip_smoke.IMAGENET_SPANS for TIMELINE_ROUNDS rounds with the stage
tracer on, and prints every stage span (plan, stage, dispatch,
device_execute, collect, the checkpoint and journal writes) and every
host batch as start and end ms from the run's start, and the
per-stage durations: where the host and the card wait on each other.
"""
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import chip_smoke as cs  # noqa: E402
import torch  # noqa: E402

PHASES = ("powersgd", "dp_sketch", "privacy", "spans", "imagenet",
          "timeline", "sched", "async_admit", "statetier", "control",
          "gpt2medium", "grid", "tpgpt2", "plan", "plangrid", "ring",
          "analysis", "audit")
TIMELINE_ROUNDS = 6


def timeline(cv_train, parse_args, corpus) -> None:
    from commefficient_tpu_torch.telemetry import (
        RunJournal, TelemetrySession,
    )
    from commefficient_tpu_torch.telemetry.journal import read_journal
    for label, extra in cs.IMAGENET_SPANS:
        cfg = parse_args(argv=cs.CONFIG4 + extra + [
            "--device", "cuda", "--dataset_dir", corpus, "--seed", "21"])
        model, opt, sched, loader, val = cv_train.build(cfg, device="cuda")
        jpath = os.path.join(corpus, f"timeline_{label}.jsonl")
        tele = TelemetrySession(journal=RunJournal(jpath), trace=True)
        model.attach_telemetry(tele)
        batches = []

        class Timed:
            steps_per_epoch = loader.steps_per_epoch
            sampler = loader.sampler

            @staticmethod
            def epoch(skip=0):
                it = loader.epoch(skip=skip)
                while True:
                    t = time.monotonic()
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    batches.append((t, time.monotonic()))
                    yield item

        torch.cuda.synchronize()
        t0 = time.monotonic()
        cv_train.train(model, opt, sched, Timed, val, model.cfg.replace(
            num_epochs=TIMELINE_ROUNDS / loader.steps_per_epoch))
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        tele.close(ok=True)
        model.close_persistence()
        spans = [s for r in read_journal(jpath)[0] if r["event"] == "trace"
                 for s in r["spans"]]
        cs.phase("timeline", f"{label}: {1e3 * wall / TIMELINE_ROUNDS:.1f} "
                 "ms/round, the eval included")
        durs = {}
        for s in spans:
            durs.setdefault(s["name"], []).append(1e3 * s["dur"])
        for name, ms in sorted(durs.items()):
            cs.phase("timeline", f"  {name}: " + " ".join(
                f"{m:.0f}" for m in ms[:10]) + " ms")
        cs.phase("timeline", "  batches: " + " ".join(
            f"{1e3 * (b - a):.0f}" for a, b in batches) + " ms")
        events = sorted([(s["t0"], s["t0"] + s["dur"], s["name"],
                          s.get("round")) for s in spans]
                        + [(a, b, "batch", None) for a, b in batches])
        for a, b, name, rnd in events:
            print(f"    {1e3 * (a - t0):9.0f} {1e3 * (b - t0):9.0f} "
                  f"{name} {'' if rnd is None else rnd}")
        del model, opt, loader, val
        torch.cuda.empty_cache()


def main(argv) -> int:
    which = argv or list(PHASES)
    unknown = set(which) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; choose from "
                         f"{PHASES}")
    if not torch.cuda.is_available():
        print("chip_phases: needs a CUDA card", file=sys.stderr)
        return 2
    from commefficient_tpu_torch import compress
    from commefficient_tpu_torch.config import parse_args
    from commefficient_tpu_torch.device import resolve_device
    from commefficient_tpu_torch.federated import client as fclient
    from commefficient_tpu_torch.federated import server as fserver
    from commefficient_tpu_torch.ops import flat, prng
    from commefficient_tpu_torch.ops.kernels import _build
    from commefficient_tpu_torch.ops.kernels import attention_cuda as ac
    from commefficient_tpu_torch.ops.kernels import sketch_cuda as sc
    from commefficient_tpu_torch.data.persona import HashTokenizer
    from commefficient_tpu_torch.ops.sketch import CSVec
    from commefficient_tpu_torch.training import cv_train, gpt2_train

    t_start = time.perf_counter()
    resolve_device("cuda")
    cs.phase("device", f"{torch.cuda.get_device_name(0)}; {cs.smi_line()}; "
             f"torch {torch.__version__}")
    _build.build()
    c2 = os.path.join(HERE, "build", "chip_smoke_data")
    tmp = tempfile.mkdtemp(prefix="chip_phases_")
    try:
        if {"plangrid", "ring"} & set(which):
            which = list(which) + ["grid"]
        if set(which) & {"powersgd", "dp_sketch", "privacy", "spans",
                         "sched", "async_admit", "control", "grid",
                         "plan", "analysis", "audit"}:
            model, round_ms, _, _, batch = cs.main_path(sc, ac, cv_train,
                                                        parse_args, c2)
            if "grid" in which:
                from commefficient_tpu_torch import models
                from commefficient_tpu_torch.models import convert
                w = model.ps_weights.detach().cpu()

                def build_resnet9():
                    module = models.build_model("ResNet9", num_classes=10)
                    convert.load_flat(module, w)
                    return module

                keep = {"cfg": model.cfg}
                cs.parity_phase("parity", build_resnet9, w, batch[1],
                                batch[2], model.cfg,
                                cv_train.make_compute_loss, cs.PARITY_RTOL,
                                cs.ACCURACY_FLOOR, fclient, fserver, flat,
                                keep=keep)
            del model
            torch.cuda.empty_cache()
        if "grid" in which:
            for row in cs.grid_rows(sc, CSVec):
                cs.phase("grid", f"kernels-line row: {row}")
            cs.grid_phase(sc, CSVec, round_ms, keep, w, batch, tmp)
        if "tpgpt2" in which:
            cs.phase("tpgpt2", f"kernels-line row: {cs.k4_tp_row(ac)}")
            cs.tpgpt2_phase(gpt2_train, parse_args, HashTokenizer, fserver,
                            None, None, tmp)
        if "plan" in which:
            cs.plan_phase(sc, ac, cv_train, parse_args, c2, round_ms,
                          os.path.join(tmp, "plan"))
        if "analysis" in which:
            os.makedirs(os.path.join(tmp, "analysis"))
            cs.analysis_phase(sc, ac, cv_train, parse_args, c2, round_ms,
                              os.path.join(tmp, "analysis"))
        if "audit" in which:
            # config #2's K1 and K2 rows of the kernels line, untimed
            sk = CSVec(d=cs.MAIN_D, c=cs.MAIN_C, r=cs.MAIN_R)
            x = torch.ones(cs.MAIN_D, device="cuda")
            rows = [dict(name=row["name"], path=row["path"],
                         bytes=row["cost"][0], ops=row["cost"][1])
                    for row in (cs.encode_row(sc, sk, x, "sketch_encode",
                                              "config2"),
                                cs.estimate_row(sc, sk, sk.encode(x),
                                                "sketch_estimate_all",
                                                "config2"))]
            del sk, x
            cs.audit_phase(sc, ac, cv_train, gpt2_train, parse_args,
                           HashTokenizer, c2,
                           os.path.join(HERE, "build",
                                        "chip_smoke_gpt2_data"), round_ms,
                           rows)
        if "powersgd" in which:
            cs.powersgd_phase(sc, ac, cv_train, parse_args, c2, fclient,
                              prng, round_ms)
        if "dp_sketch" in which:
            cs.dp_sketch_phase(sc, ac, cv_train, parse_args, c2, fclient,
                               fserver, compress, round_ms, tmp)
        if "privacy" in which:
            cs.privacy_drill_phase(cv_train, parse_args, c2, compress, tmp)
        if "spans" in which:
            cs.spans_phase(sc, ac, cv_train, parse_args, c2, round_ms, tmp)
        if "sched" in which:
            cs.sched_phase(sc, ac, cv_train, parse_args, c2, round_ms, tmp)
        if "async_admit" in which:
            cs.async_phase(sc, ac, cv_train, parse_args, c2, round_ms, tmp)
        if "control" in which:
            cs.control_phase(sc, ac, cv_train, parse_args, c2, round_ms,
                             tmp)
        if "gpt2medium" in which:
            rows = cs.gpt2medium_kernels(sc, ac, CSVec)
            launches = cs.gpt2medium_phase(
                sc, ac, gpt2_train, parse_args, HashTokenizer,
                os.path.join(HERE, "build", "chip_smoke_gpt2_data"),
                fserver)
            for row in rows:
                row["launches"] = launches[row.pop("counter")]
                cs.phase("gpt2medium", f"kernels-line row: {row}")
        if "statetier" in which:
            spe = -(-cs.CLIENTS * cs.EXAMPLES_PER_CLIENT // (8 * 32))
            model, rr, _ = cs.mode_path(
                "ltopk", sc, ac, cv_train, flat, parse_args, cs.CONFIG3,
                cs.LTOPK_ROUNDS, spe, cs.CONFIG3_D,
                os.path.join(HERE, "build", "chip_smoke_cifar100_data"))
            del model
            torch.cuda.empty_cache()
            cs.statetier_phase(sc, ac, cv_train, parse_args, rr.peak, tmp)
        if {"imagenet", "timeline"} & set(which):
            corpus = os.path.join(tmp, "imagenet")
            cs.write_imagenet_corpus(corpus)
            if "imagenet" in which:
                model, rr, loader = cs.imagenet_path(
                    "imagenet", sc, ac, cv_train, parse_args, cs.CONFIG4,
                    cs.FIXUP50_D, corpus)
                del model, loader
                torch.cuda.empty_cache()
                cs.imagenet_pipeline_phase(sc, ac, cv_train, parse_args,
                                           corpus, rr.round_ms)
            if "timeline" in which:
                timeline(cv_train, parse_args, corpus)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cs.phase("wall", f"{time.perf_counter() - t_start:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
