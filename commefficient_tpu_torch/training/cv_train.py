"""CV federated training driver: the port of
commefficient_tpu/training/cv_train.py (reference cv_train.py).

Same flags (config.parse_args), loss callback contract, epoch loop,
LR schedule, table columns, communication-MiB reporting, `--test`
smoke shrink, NaN abort, and EMNIST's per-step log line, for CIFAR10,
CIFAR100, EMNIST and ImageNet; the run journal (on by default, under
the run directory or --journal_path), `--checkpoint_every`,
`--checkpoint`, `--resume` (training/persist.py), `--trace`,
`--profile` and `--tensorboard`; `--finetune --finetuned_from
<dataset>` (finetune_from_checkpoint) and the fault flags of
utils/faults.py with the numeric rollback; `--scan_rounds` (spans of
--scan_span rounds, training/scanloop.py), `--pipeline`,
`--ckpt_every_spans` and `--profile_spans`; the round scheduler
(`--sampler`, `--deadline_quantile`, `--target_survivors`,
scheduler/), `--async_admit_rounds`, `--state_tier host` and the
controllers (`--target_screened_rate`, `--speed_match`,
`--scan_span_palette`, `--adapt_staleness`, control/), and a grid of
ranks (`--multihost`, `--num_slices`, parallel/) with the plan
transport (`--plan_transport collective|emulated`,
parallel/plantransport.py: attached after the scheduler, its journaled
plan stream loaded on `--resume` with `--journal_path`), and
`--debug_transfer_guard` (analysis/runtime.forbid_transfers around
every round or span after the first).

Run on the card:
    python -m commefficient_tpu_torch.training.cv_train --mode sketch \
        --error_type virtual --virtual_momentum 0.9 --local_momentum 0 \
        --num_workers 8 --k 50000 --num_rows 5 --num_cols 500000
and on the CPU with `--device cpu` (the kernels' plain versions).
One rank a GPU, N ranks: the same command with `--multihost
--num_processes N --process_id i --coordinator_address host:port` for
each i (nccl).
Only rank 0 prints, journals and writes checkpoints.
"""
from __future__ import annotations

import contextlib
import math
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from commefficient_tpu_torch import models
from commefficient_tpu_torch.config import (
    Config, num_classes_of_dataset, parse_args,
)
from commefficient_tpu_torch.data import (
    FedCIFAR10, FedCIFAR100, FedEMNIST, FedImageNet, FedLoader,
    FedValLoader, transforms,
)
from commefficient_tpu_torch.federated.api import FedModel, FedOptimizer
from commefficient_tpu_torch.ops import lowp
from commefficient_tpu_torch.ops.flat import module_layout
from commefficient_tpu_torch.parallel import multihost as mh
from commefficient_tpu_torch.parallel.mesh import default_layout
from commefficient_tpu_torch.parallel.plantransport import (
    attach_config_transport,
)
from commefficient_tpu_torch.scheduler import attach_round_scheduler
from commefficient_tpu_torch.telemetry.trace import TRACE
from commefficient_tpu_torch.training import persist
from commefficient_tpu_torch.training.scanloop import (
    make_span_checkpoint, run_scanned_rounds,
)
from commefficient_tpu_torch.utils.checkpoint import (
    latest_checkpoint_path, load_checkpoint, transfer_for_finetune,
)
from commefficient_tpu_torch.utils.logging import (
    TableLogger, Timer, make_logdir,
)
from commefficient_tpu_torch.utils.schedules import LambdaLR, PiecewiseLinear


# ---------------- loss callback (reference cv_train.py:67-83) ------------

def make_compute_loss(model: torch.nn.Module):
    """Masked cross-entropy + accuracy under the loss contract:
    loss_fn(params, (images, labels), mask) -> (mean loss, (mean acc,))."""

    def compute_loss(params, batch, mask):
        images, labels = batch
        logits = torch.func.functional_call(model, params, (images,))
        logp = lowp.log_softmax(logits, dim=-1)
        nll = -logp.gather(1, labels.long()[:, None])[:, 0]
        denom = torch.clamp(mask.sum(), min=1.0)
        loss = (nll * mask).sum() / denom
        acc = ((logits.argmax(-1) == labels.long()).to(mask.dtype)
               * mask).sum() / denom
        return loss, (acc,)

    return compute_loss


# ---------------- data ----------------------------------------------------

# name -> (dataset class, transform factory, --test synthetic sizes):
# EMNIST's are (writers, images a writer), the others' (train, val)
_DATASETS = {
    "CIFAR10": (FedCIFAR10, transforms.cifar10_transforms, (2048, 512)),
    "CIFAR100": (FedCIFAR100, transforms.cifar100_transforms, (2048, 512)),
    "EMNIST": (FedEMNIST, transforms.femnist_transforms, (64, 16)),
    "ImageNet": (FedImageNet, transforms.imagenet_transforms, (512, 64)),
}


def get_data_loaders(cfg: Config,
                     synthetic_examples: Optional[Tuple[int, int]] = None,
                     val_shards: int = 1):
    """Train and val loaders. `synthetic_examples=(n_train, n_val)` asks
    for the synthetic corpus when no archives are on disk (`--test`
    asks for (2048, 512)). `val_shards`: the eval's shards, one a rank
    of the clients axis."""
    try:
        dataset_cls, transform_factory, test_sizes = \
            _DATASETS[cfg.dataset_name]
    except KeyError:
        raise ValueError(
            f"cv_train supports {sorted(_DATASETS)}; for PERSONA use "
            f"gpt2_train") from None
    train_t, test_t = transform_factory(seed=cfg.seed)
    synthetic = synthetic_examples or (test_sizes if cfg.do_test else None)
    kw = dict(do_iid=cfg.do_iid, num_clients=cfg.num_clients,
              seed=cfg.seed, synthetic_examples=synthetic)
    train_set = dataset_cls(cfg.dataset_dir, transform=train_t, train=True,
                            **kw)
    val_set = dataset_cls(cfg.dataset_dir, transform=test_t, train=False,
                          **kw)
    train_loader = FedLoader(train_set, cfg.num_workers,
                             cfg.local_batch_size, seed=cfg.seed,
                             max_local_batch=cfg.max_local_batch)
    val_loader = FedValLoader(val_set, cfg.valid_batch_size,
                              num_shards=val_shards)
    return train_loader, val_loader


# ---------------- training loop (reference cv_train.py:85-250) -----------

def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def run_eval(model: FedModel, val_loader) -> tuple:
    model.train(False)
    tot_loss = tot_acc = tot_n = 0.0
    for data, mask in val_loader.batches():
        loss, acc, count = model((data, mask))
        tot_loss += float((loss * count).sum())
        tot_acc += float((acc * count).sum())
        tot_n += float(count.sum())
    model.train(True)
    denom = max(tot_n, 1.0)
    return tot_loss / denom, tot_acc / denom


def train(model: FedModel, opt: FedOptimizer, lr_scheduler,
          train_loader, val_loader, cfg: Config, loggers=(),
          timer: Optional[Timer] = None,
          on_round: Optional[Callable[[int, list], None]] = None,
          log_dir: str = "") -> bool:
    """The epoch loop: rounds until ceil(num_epochs * steps_per_epoch)
    are done, an eval and a table row per epoch (journaled as an `epoch`
    event), a rotated checkpoint every --checkpoint_every epochs. A
    resumed model counts its restored rounds against that budget and
    continues the restored sampler stream. `on_round(i, outputs)` is
    called after round i's dispatch with model(batch)'s outputs (a
    measuring caller synchronizes the device there); under
    --scan_rounds it is called as round i is emitted, with its (loss,
    acc) rows. Returns False on a NaN/divergent loss. EMNIST prints a
    line a round (reference cv_train.py:233-237)."""
    timer = timer or Timer()
    coord = mh.is_coordinator()
    per_step_log = cfg.dataset_name == "EMNIST" and coord
    spe = train_loader.steps_per_epoch
    total_rounds = math.ceil(cfg.num_epochs * spe)
    sampler = train_loader.sampler
    # on resume num_epochs is the TOTAL budget; a restored sampler
    # stream continues where it stopped (skip 0), a checkpoint without
    # one replays the epoch head
    rounds_done = int(model.server.round_idx)
    epoch = rounds_done // spe
    skip_rounds = sampler.resolve_resume(rounds_done % spe)
    if (sampler.pending_pos or 0) >= spe:
        # the uninterrupted run abandoned this stream at the cap
        sampler.discard_pending()
    ckpt_prefix = _ckpt_path(cfg)
    # --debug_transfer_guard: every round after this call's first runs
    # under the implicit-sync guard (the first builds the kernels and
    # fills the caches), as the JAX driver guards its steady state
    guard = persist.transfer_guard(model, cfg)
    warmed = False
    total_down = total_up = 0.0
    writer = (persist.try_tensorboard(log_dir)
              if cfg.use_tensorboard and coord else None)
    profile = None
    profiled = False
    while rounds_done < total_rounds:
        epoch += 1
        if cfg.do_profile and not profiled and coord:
            profile = persist.EpochProfile(log_dir, model.device)
            profiled = True
        losses, accs = [], []
        down = up = 0.0

        step_t0 = time.monotonic()

        # metrics come to the host one round late, so the host does not
        # wait on the round it just queued
        def emit(p) -> bool:
            nonlocal step_t0
            losses.append(float(np.mean(_host(p[0]))))
            accs.append(float(np.mean(_host(p[1]))))
            if per_step_log:
                now = time.monotonic()
                print("LR: {:0.5f}, Loss: {:0.5f}, Acc: {:0.5f}, "
                      "Time: {:0.2f}".format(float(p[2]), losses[-1],
                                             accs[-1], now - step_t0))
                step_t0 = now
            return not np.isnan(losses[-1])

        pending = None
        if model.scheduler is not None:
            # the scheduler's counter starts at the epoch's first round:
            # a resumed epoch re-selects its skipped head
            model.scheduler.begin_epoch(rounds_done - skip_rounds)
        stream = iter(train_loader.epoch(skip=skip_rounds))
        skip_rounds = 0
        if cfg.scan_rounds:
            def span_stream():
                # the budget before the draw, as the loop below
                nonlocal rounds_done
                while rounds_done < total_rounds:
                    try:
                        client_ids, data, mask = next(stream)
                    except StopIteration:
                        return
                    lr_scheduler.step()
                    lr = opt.param_groups[0]["lr"]
                    rounds_done += 1
                    yield (rounds_done - 1, lr), client_ids, data, mask, lr
                sampler.abandon_epoch()

            def span_emit(tag, loss_w, acc_w) -> bool:
                if on_round is not None:
                    on_round(tag[0], [loss_w, acc_w])
                return emit((loss_w, acc_w, tag[1]))

            def on_comm(d, u):
                nonlocal down, up
                down += float(d)
                up += float(u)

            run_scanned_rounds(
                model, span_stream(),
                # the palette's controller picks each span's length
                (model.control_bank if cfg.span_palette
                 else cfg.scan_span if cfg.scan_span > 0 else spe),
                span_emit, on_comm,
                checkpoint=make_span_checkpoint(ckpt_prefix, model, cfg,
                                                lr_scheduler),
                pipeline=cfg.pipeline, guard=guard)
        # the round budget is checked BEFORE the next round is drawn, so
        # ending early never draws (and discards) a round; the stream is
        # then abandoned, so a later checkpoint records no live epoch
        while not cfg.scan_rounds:
            if rounds_done >= total_rounds:
                sampler.abandon_epoch()
                break
            with TRACE.span("train_round", round=rounds_done):
                try:
                    client_ids, data, mask = next(stream)
                except StopIteration:
                    break
                lr_scheduler.step()
                with (guard() if guard is not None and warmed
                      else contextlib.nullcontext()):
                    out = model((client_ids, data, mask))
                warmed = True
                opt.step()
                if on_round is not None:
                    on_round(rounds_done, out)
                loss, acc, d, u = out
                down += float(np.sum(d))
                up += float(np.sum(u))
                if pending is not None and not emit(pending):
                    pending = None
                    break
                pending = (loss, acc, opt.param_groups[0]["lr"])
                rounds_done += 1
        if pending is not None:
            emit(pending)
        total_down += down
        total_up += up
        if profile is not None:
            profile.stop()
            profile = None
        train_time = timer()

        mean_loss = float(np.mean(losses)) if losses else float("nan")
        mean_acc = float(np.mean(accs)) if accs else float("nan")
        if np.isnan(mean_loss) or mean_loss > cfg.nan_threshold:
            # every rank computes the same mean, so all abort together
            if coord:
                print(f"found nan/divergent loss {mean_loss}, aborting")
            return False

        val_loss, val_acc = run_eval(model, val_loader)
        val_time = timer()
        row = {
            "epoch": epoch,
            "lr": round(float(opt.param_groups[0]["lr"]), 5),
            "train_time": train_time,
            "train_loss": mean_loss,
            "train_acc": mean_acc,
            "test_time": val_time,
            "test_loss": val_loss,
            "test_acc": val_acc,
            "down (MiB)": float(total_down / (1024 ** 2)),
            "up (MiB)": float(total_up / (1024 ** 2)),
            "total_time": timer.total_time,
        }
        for logger in loggers:
            logger.append(row)
        if writer is not None:
            for name, value in row.items():
                if name != "epoch":
                    writer.add_scalar(name.split(" ")[0], value, epoch)
        if model.telemetry is not None:
            # the one-round-late round, then the table row
            model.telemetry.flush()
            model.telemetry.journal_event(
                "epoch", **{k.replace(" (MiB)", "_mib"): v
                            for k, v in row.items()})
            model.telemetry.mark_steady_state()
        if cfg.checkpoint_every and epoch % cfg.checkpoint_every == 0:
            persist.checkpoint_epoch(model, lr_scheduler, ckpt_prefix, cfg,
                                     rounds_done)
    if writer is not None:
        writer.close()
    return True


def run(model: FedModel, opt: FedOptimizer, lr_scheduler, train_loader,
        val_loader, cfg: Config, log_dir: str, loggers=(),
        timer: Optional[Timer] = None,
        on_round: Optional[Callable[[int, list], None]] = None) -> bool:
    """What main() does with a built model: --resume, the telemetry
    session, train() (a numeric trip rolls back to the newest finite
    checkpoint and re-enters it, persist.train_with_rollback),
    --checkpoint; the session is closed (`run_end`) whatever
    happens."""
    fallbacks = []
    if cfg.resume:
        persist.resume(model, lr_scheduler, _ckpt_path(cfg), fallbacks,
                       cfg.journal_path)
    tele = persist.start_telemetry(model, cfg, log_dir, "cv_train",
                                   fallbacks)
    ok = False
    try:
        ok = persist.train_with_rollback(
            lambda: train(model, opt, lr_scheduler, train_loader,
                          val_loader, cfg, loggers=loggers, timer=timer,
                          on_round=on_round, log_dir=log_dir),
            model, lr_scheduler, _ckpt_path(cfg), cfg, tele)
        model.finalize()
        if cfg.do_checkpoint:
            persist.checkpoint_final(model, lr_scheduler, _ckpt_path(cfg),
                                     cfg)
    finally:
        persist.close(model, tele, ok)
    return ok


def build(cfg: Config, device="cuda",
          synthetic_examples: Optional[Tuple[int, int]] = None,
          layout=None):
    """Loaders, model, optimizer and LR scheduler for `cfg`: what main()
    wires before it calls train(). `--test` shrinks the sketch to 1 x 10
    with k = 10 and a model that takes `channels` (ResNet9) to one
    channel per layer (reference cv_train.py:329-336). The model's input
    channels and spatial size come from the first transformed image
    (the ResNet101LN's LayerNorms are built for that size). --finetune
    freezes the transferred parameters (finetune_from_checkpoint); the
    Fixup nets train their scalar biases and scales at 0.1x the
    learning rate (reference cv_train.py:366-376). Under
    torch.distributed (--multihost) the model takes the default rank
    layout (or `layout`) and the loaders feed the rank's rows."""
    if layout is None and mh.is_distributed():
        layout = default_layout(cfg)
    model_config = {}
    if cfg.do_test:
        model_config["channels"] = {"prep": 1, "layer1": 1,
                                    "layer2": 1, "layer3": 1}
        cfg = cfg.replace(num_cols=10, num_rows=1, k=10)
    model_config.update(num_classes=num_classes_of_dataset(cfg.dataset_name),
                        do_batchnorm=cfg.do_batchnorm, seed=cfg.seed)
    train_loader, val_loader = get_data_loaders(
        cfg, synthetic_examples,
        val_shards=1 if layout is None else layout.clients)
    x0 = train_loader.dataset.get_client_batch(0, np.array([0]))[0]
    model_config["initial_channels"] = int(x0.shape[-1])
    model_config["input_hw"] = tuple(int(s) for s in x0.shape[1:3])
    module = models.build_model(cfg.model, **model_config)
    lr_scale_vec = None
    if cfg.do_finetune:
        lr_scale_vec = finetune_from_checkpoint(cfg, module, model_config)
    if cfg.model.startswith("Fixup"):
        # the JAX driver's order: the Fixup scales replace the finetune
        # freeze (ROADMAP.md Queue 3)
        lr_scale_vec = fixup_lr_scales(module)
    model = FedModel(module, make_compute_loss(module), cfg, device=device,
                     num_clients=train_loader.dataset.num_clients,
                     lr_scale_vec=lr_scale_vec, layout=layout)
    if model.layout is not None:
        # per-rank batch feeding: each rank materializes its rows only
        mh.apply_feed_slices(model, train_loader, val_loader,
                             cfg.num_workers, val_loader.num_shards)
    # the round scheduler on the loader's sampler and the model, and the
    # sampler's stream in checkpoints (before any --resume, so sched_*
    # and smp_* land in them)
    attach_round_scheduler(model, train_loader)
    # --plan_transport: the collective transport on that scheduler, or
    # the emulated controllers in its place (before any --resume too)
    attach_config_transport(model, train_loader, model.cfg)
    opt = FedOptimizer(model)
    # cifar10-fast schedule: knots [0, pivot, num_epochs] -> [0, lr, 0]
    lr_scale = cfg.lr_scale if cfg.lr_scale is not None else 0.4
    schedule = PiecewiseLinear([0, cfg.pivot_epoch, cfg.num_epochs],
                               [0, lr_scale, 0])
    spe = train_loader.steps_per_epoch
    lr_scheduler = LambdaLR(opt, lr_lambda=lambda step: schedule(step / spe))
    return model, opt, lr_scheduler, train_loader, val_loader


def finetune_from_checkpoint(cfg: Config, module: torch.nn.Module,
                             model_config: dict) -> np.ndarray:
    """--finetune: load the newest checkpoint under
    --finetune_path/<model> (the manifest's, else the newest stamped
    file, else <model>.npz: a preempted pretraining run still counts),
    transfer every parameter whose path and shape match into `module`
    (a model of --finetuned_from's class count is the old layout; the
    new head stays fresh), and return the per-parameter LR scales: 0 at
    the transferred (frozen) coordinates, 1 elsewhere (reference
    cv_train.py:377-384 freezes with requires_grad=False)."""
    if cfg.finetuned_from is None:
        raise ValueError("--finetuned_from is required with --finetune")
    src = latest_checkpoint_path(os.path.join(cfg.finetune_path, cfg.model))
    if src is None:
        raise FileNotFoundError(
            f"no checkpoint for model {cfg.model!r} under --finetune_path "
            f"{cfg.finetune_path!r}")
    old_server = load_checkpoint(src).server
    old_module = models.build_model(cfg.model, **{
        **model_config,
        "num_classes": num_classes_of_dataset(cfg.finetuned_from)})
    _, frozen = transfer_for_finetune(old_module, old_server.ps_weights,
                                      module)
    return np.where(frozen > 0, 0.0, 1.0).astype(np.float32)


def fixup_lr_scales(module: torch.nn.Module) -> np.ndarray:
    """Flat per-parameter LR-scale vector: 0.1 for the bias and scale
    scalars, 1.0 elsewhere (reference param groups, cv_train.py:366-376;
    the JAX driver's name test on the flax path)."""
    segs = []
    for e in module_layout(module):
        names = "/".join(e.path).lower()
        scale = 0.1 if ("bias" in names or "scale" in names
                        or "mul" in names or "add" in names) else 1.0
        segs.append(np.full(e.size, scale, np.float32))
    return np.concatenate(segs)


def _ckpt_path(cfg: Config) -> str:
    return os.path.join(cfg.checkpoint_path, cfg.model)


def main(argv=None) -> bool:
    """The CLI. Under --multihost the rank joins its grid first
    (multihost.initialize: nccl on the card, gloo on the CPU)."""
    cfg = parse_args(argv=argv)
    device = cfg.device
    if cfg.multihost:
        # before the model touches a device: the rank's card
        mh.initialize_from_config(cfg)
        device = mh.rank_device(cfg.device)
    coord = mh.is_coordinator()
    if coord:
        print(cfg)
    timer = Timer()
    np.random.seed(cfg.seed)
    model, opt, lr_scheduler, train_loader, val_loader = build(
        cfg, device=device)
    if coord:
        print(f"Finished initializing in {timer():.2f} seconds")
    t0 = time.monotonic()
    # only the coordinator makes a run directory and prints the table
    ok = run(model, opt, lr_scheduler, train_loader, val_loader, model.cfg,
             make_logdir(cfg) if coord else "",
             loggers=(TableLogger(),) if coord else (), timer=timer)
    if coord:
        print(f"trained in {time.monotonic() - t0:.2f} seconds")
    return ok


def cli() -> None:
    raise SystemExit(0 if main() else 1)


if __name__ == "__main__":
    cli()
