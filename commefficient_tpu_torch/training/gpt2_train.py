"""GPT2 / PersonaChat federated training driver: the port of
commefficient_tpu/training/gpt2_train.py (reference gpt2_train.py).

Same flags (config.parse_args, default lr 4e-2), the double-heads loss
callbacks with the same normalisation, the one-round-lag metric emit,
the NaN abort, the epoch-1-only communication totals, the HF-style
artifact and the final validation; the run journal, `--checkpoint_every`,
`--checkpoint`, `--resume` (training/persist.py, the resumed epoch's
stream continued), `--trace` and `--profile`. The round underneath is the same
engine cv_train drives; at config #5 it takes the fused client backward
(Config.fused_client_backward) and the threshold decode (kernel K3);
GPT2-medium and larger sketch past the threshold decode's reach and
take the blockwise decode (kernel K2 a window of chunks at a time);
sequences of 256 tokens or more take flash attention (kernel K4).
Weights come from a save_pretrained artifact of either package, a
locally cached HF checkpoint, or random from --seed
(build_model_and_params); --finetune evaluates the artifact at
--finetune_path, and --remat recomputes each block in the backward.
`--scan_rounds`, `--pipeline`, `--ckpt_every_spans` and
`--profile_spans` run the rounds in spans (training/scanloop.py); the
round scheduler, `--async_admit_rounds`, `--state_tier host` and the
controllers run as in cv_train. A grid of ranks runs as in cv_train
(`--multihost`, `--num_slices`, parallel/), and `--model_parallel N`
splits each block's attention heads, MLP units and the tied embedding's
vocabulary over N ranks (parallel/tp.py; it prints `tensor parallel:
mesh {...}` as the JAX driver does). `--plan_transport` attaches the
control plane (parallel/plantransport.py) as in cv_train, and
`--debug_transfer_guard` guards every round or span after the first
(analysis/runtime.forbid_transfers), as in cv_train.

Run on the card:
    python -m commefficient_tpu_torch.training.gpt2_train \\
        --dataset_name PERSONA --mode sketch --error_type virtual \\
        --virtual_momentum 0.9 --local_momentum 0 --num_workers 8
and on the CPU with `--device cpu` (the kernels' plain versions), e.g.
`--test --device cpu` for the smoke size. Two ranks of one layer each:
`--model_parallel 2 --multihost --num_processes 2 --process_id i
--coordinator_address host:port` for i = 0, 1 (nccl, one GPU a rank).
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from commefficient_tpu_torch.config import Config, parse_args
from commefficient_tpu_torch.data.loader import FedLoader, FedValLoader
from commefficient_tpu_torch.data.persona import (
    IGNORE_INDEX, FedPERSONA, make_tokenizer,
)
from commefficient_tpu_torch.federated.api import FedModel, FedOptimizer
from commefficient_tpu_torch.parallel import multihost as mh
from commefficient_tpu_torch.parallel.mesh import default_layout
from commefficient_tpu_torch.parallel.plantransport import (
    attach_config_transport,
)
from commefficient_tpu_torch.parallel.tp import tp_loss
from commefficient_tpu_torch.models.convert import (
    from_jax_params, load_flat, to_jax_params,
)
from commefficient_tpu_torch.models.gpt2 import (
    PRESETS, GPT2Config, GPT2DoubleHeads, load_pretrained_dir,
    resize_position_embeddings, resize_token_embeddings, save_pretrained,
    try_load_pretrained,
)
from commefficient_tpu_torch.ops import lowp, prng
from commefficient_tpu_torch.scheduler import attach_round_scheduler
from commefficient_tpu_torch.telemetry.trace import TRACE
from commefficient_tpu_torch.training import persist
from commefficient_tpu_torch.training.scanloop import (
    make_span_checkpoint, run_scanned_rounds,
)
from commefficient_tpu_torch.utils.checkpoint import save_checkpoint
from commefficient_tpu_torch.utils.logging import (
    SilentLogger, TableLogger, Timer, make_logdir,
)
from commefficient_tpu_torch.utils.schedules import LambdaLR, PiecewiseLinear

DEFAULT_LR = 4e-2


# ---------------- loss callbacks (reference gpt2_train.py:77-99) ---------

def _lm_nll(lm_logits, lm_labels, mask):
    """Shifted next-token NLL over the non-ignored labels of valid
    examples: sum(nll * valid) / max(sum(valid), 1)."""
    logits = lm_logits[..., :-1, :]
    labels = lm_labels[..., 1:].long()
    valid = (labels != IGNORE_INDEX).to(mask.dtype) * mask[:, None, None]
    safe = labels.clamp(min=0)
    logp = lowp.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def _mc_loss_acc(mc_logits, mc_labels, mask):
    """Candidate-choice cross-entropy and accuracy (the double head)."""
    labels = mc_labels.long()
    logp = lowp.log_softmax(mc_logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    acc = ((mc_logits.argmax(-1) == labels).to(mask.dtype)
           * mask).sum() / denom
    return loss, acc


def make_compute_loss_train(model: GPT2DoubleHeads, cfg: Config):
    def compute_loss(params, batch, mask):
        input_ids, mc_token_ids, lm_labels, mc_labels, token_type_ids = batch
        lm_logits, mc_logits = torch.func.functional_call(
            model, params, (input_ids, token_type_ids, mc_token_ids))
        lm = _lm_nll(lm_logits, lm_labels, mask)
        mc, _ = _mc_loss_acc(mc_logits, mc_labels, mask)
        return lm * cfg.lm_coef + mc * cfg.mc_coef, (lm, mc)
    return compute_loss


def make_compute_loss_val(model: GPT2DoubleHeads):
    """Val = (NLL, (accuracy,)); perplexity is exp(mean NLL), computed
    by the caller over the whole val set."""
    def compute_loss(params, batch, mask):
        input_ids, mc_token_ids, lm_labels, mc_labels, token_type_ids = batch
        lm_logits, mc_logits = torch.func.functional_call(
            model, params, (input_ids, token_type_ids, mc_token_ids))
        nll = _lm_nll(lm_logits, lm_labels, mask)
        _, acc = _mc_loss_acc(mc_logits, mc_labels, mask)
        return nll, (acc,)
    return compute_loss


# ---------------- data (reference gpt2_train.py:315-355) -----------------

def get_data_loaders(cfg: Config, tokenizer,
                     synthetic_examples: Optional[Tuple[int, int, int]]
                     = None, val_shards: int = 1):
    """Train and val loaders. `synthetic_examples=(personas,
    dialogs_per_persona, utterances_per_dialog)` asks for the synthetic
    corpus when no PersonaChat JSON is on disk (`--test` asks for (8, 2,
    3)). `val_shards`: one a rank of the clients axis."""
    synthetic = synthetic_examples or ((8, 2, 3) if cfg.do_test else None)
    common = dict(dataset_dir=cfg.dataset_dir, tokenizer=tokenizer,
                  num_candidates=cfg.num_candidates,
                  max_history=cfg.max_history, do_iid=cfg.do_iid,
                  seed=cfg.seed, synthetic_examples=synthetic)
    train_set = FedPERSONA(
        personality_permutations=cfg.personality_permutations,
        num_clients=cfg.num_clients, train=True, **common)
    val_set = FedPERSONA(
        personality_permutations=cfg.personality_permutations,
        train=False, **common)
    train_loader = FedLoader(train_set, cfg.num_workers,
                             cfg.local_batch_size, seed=cfg.seed,
                             max_local_batch=cfg.max_local_batch)
    val_loader = FedValLoader(val_set, cfg.valid_batch_size,
                              num_shards=val_shards)
    return train_loader, val_loader


# ---------------- eval (reference test_gpt2, gpt2_train.py:149-167) ------

def run_eval(model: FedModel, val_loader):
    model.train(False)
    tot_nll = tot_acc = tot_n = 0.0
    for data, mask in val_loader.batches():
        nll, acc, count = model((data, mask))
        tot_nll += float((nll * count).sum())
        tot_acc += float((acc * count).sum())
        tot_n += float(count.sum())
    model.train(True)
    denom = max(tot_n, 1.0)
    nll = tot_nll / denom
    return nll, tot_acc / denom, float(np.exp(min(nll, 50.0)))


# ---------------- training loop (reference run_batches, :169-253) --------

def train_gpt2(model: FedModel, opt: FedOptimizer, lr_scheduler,
               train_loader, cfg: Config, logger=None,
               timer: Optional[Timer] = None,
               on_round: Optional[Callable[[int, list], None]] = None,
               log_dir: str = "") -> bool:
    """ceil(num_epochs) epochs of rounds, the last one cut to its
    fraction; a table row per round, emitted one round late so the host
    never waits on the round it just queued; an `epoch` journal event
    and, every --checkpoint_every epochs, a rotated checkpoint. A
    resumed model counts its restored rounds against the budget and
    continues the restored sampler stream. `on_round(i, outputs)` is
    called after round i's dispatch with model(batch)'s outputs (a
    measuring caller synchronizes the device there); under
    --scan_rounds it is called as round i is emitted, with its (loss,
    lm, mc) rows. Returns False on a NaN/divergent loss."""
    timer = timer or Timer()
    coord = mh.is_coordinator()
    logger = logger or (TableLogger() if coord else SilentLogger())
    spe = train_loader.steps_per_epoch
    sampler = train_loader.sampler
    epoch_download = epoch_upload = 0.0
    # on resume num_epochs is the TOTAL budget (cv_train.train's rule)
    batch_idx = int(model.server.round_idx)
    start_epoch = batch_idx // spe
    skip_rounds = sampler.resolve_resume(batch_idx % spe)
    if (sampler.pending_pos or 0) >= spe:
        sampler.discard_pending()
    ckpt_prefix = _ckpt_path(cfg)
    # --debug_transfer_guard: every round after this call's first runs
    # under the implicit-sync guard (cv_train.train's rule)
    guard = persist.transfer_guard(model, cfg)
    warmed = False
    losses = []
    profile = (persist.EpochProfile(log_dir, model.device)
               if cfg.do_profile and coord else None)

    def emit(p) -> bool:
        bidx, lr_v, l_, lm_, mc_ = p
        losses.append(float(l_.mean()))
        logger.append({
            "batch_idx": bidx,
            "lr": round(lr_v, 5),
            "train_time": timer(),
            "train_loss": losses[-1],
            "lm_loss": float(lm_.mean()),
            "mc_loss": float(mc_.mean()),
            "total_time": timer.total_time,
        })
        return not (np.isnan(losses[-1]) or losses[-1] > cfg.nan_threshold)

    for epoch in range(start_epoch, math.ceil(cfg.num_epochs)):
        frac = (cfg.num_epochs - epoch
                if epoch == math.ceil(cfg.num_epochs) - 1 else 1.0)
        pending = None
        aborted = False
        if model.scheduler is not None:
            # the scheduler's counter starts at the epoch's first round
            model.scheduler.begin_epoch(batch_idx - skip_rounds)
        stream = iter(train_loader.epoch(skip=skip_rounds))
        skip_rounds = 0
        if cfg.scan_rounds:
            def span_stream():
                # the epoch's cap before the draw, as the loop below
                nonlocal batch_idx
                while batch_idx - epoch * spe < spe * frac:
                    try:
                        client_ids, data, mask = next(stream)
                    except StopIteration:
                        return
                    lr_scheduler.step()
                    batch_idx += 1
                    lr_v = float(opt.param_groups[0]["lr"])
                    yield ((batch_idx, lr_v), client_ids, data, mask,
                           opt.param_groups[0]["lr"])
                sampler.abandon_epoch()

            def span_emit(tag, l_, lm_, mc_) -> bool:
                if on_round is not None:
                    on_round(tag[0] - 1, [l_, lm_, mc_])
                return emit((tag[0], tag[1], l_, lm_, mc_))

            def on_comm(d, u):
                nonlocal epoch_download, epoch_upload
                if epoch == 0:
                    epoch_download += float(d) / (1024 ** 2)
                    epoch_upload += float(u) / (1024 ** 2)

            aborted = not run_scanned_rounds(
                model, span_stream(),
                # the palette's controller picks each span's length
                (model.control_bank if cfg.span_palette
                 else cfg.scan_span if cfg.scan_span > 0 else spe),
                span_emit, on_comm,
                checkpoint=make_span_checkpoint(ckpt_prefix, model, cfg,
                                                lr_scheduler),
                pipeline=cfg.pipeline, guard=guard)
        while not cfg.scan_rounds:
            if batch_idx - epoch * spe >= spe * frac:
                # the epoch's cap: abandon without drawing, so a later
                # checkpoint records no live epoch
                sampler.abandon_epoch()
                break
            with TRACE.span("train_round", round=batch_idx):
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
                    on_round(batch_idx, out)
                loss, lm, mc, down, up = out
                batch_idx += 1
                if epoch == 0:
                    # download totals are only trusted for epoch 1
                    # (reference gpt2_train.py:132-137)
                    epoch_download += float(np.sum(down)) / (1024 ** 2)
                    epoch_upload += float(np.sum(up)) / (1024 ** 2)
                if pending is not None and not emit(pending):
                    pending = None
                    aborted = True
                    break
                pending = (batch_idx, float(opt.param_groups[0]["lr"]),
                           loss, lm, mc)
        if pending is not None and not emit(pending):
            aborted = True
        if profile is not None:
            profile.stop()
            profile = None
        if aborted:
            # every rank computes the same losses, so all abort together
            if coord:
                print(f"found nan/divergent loss {losses[-1]}, aborting")
            return False
        if model.telemetry is not None:
            model.telemetry.flush()
            model.telemetry.journal_event(
                "epoch", epoch=epoch,
                train_loss=(losses[-1] if losses else None),
                rounds=batch_idx)
            model.telemetry.mark_steady_state()
        if cfg.checkpoint_every and epoch % cfg.checkpoint_every == 0:
            persist.checkpoint_epoch(model, lr_scheduler, ckpt_prefix, cfg,
                                     batch_idx)

    n_clients = model.num_clients
    if not coord:
        return True
    print(f"Total Download (MiB): {epoch_download:0.2f} (only epoch 1)")
    print(f"Total Upload (MiB): {epoch_upload:0.2f} (only epoch 1)")
    print(f"Avg Download Per Client: {epoch_download / n_clients:0.2f}"
          f" (only epoch 1)")
    print(f"Avg Upload Per Client: {epoch_upload / n_clients:0.2f}"
          f" (only epoch 1)")
    return True


def test_gpt2(model: FedModel, val_loader, timer: Optional[Timer] = None,
              logger=None) -> dict:
    timer = timer or Timer()
    nll, acc, ppl = run_eval(model, val_loader)
    stats = {"val_nll": nll, "val_acc": acc, "val_ppl": ppl,
             "val_time": timer(), "total_time": timer.total_time}
    (logger or (TableLogger() if mh.is_coordinator()
                else SilentLogger())).append(stats)
    return stats


# ---------------- main (reference train(), gpt2_train.py:255-313) --------

def build_model_and_params(cfg: Config, tokenizer, seq_len: int,
                           source: Optional[str] = None,
                           require_load: bool = False) -> GPT2DoubleHeads:
    """The GPT2 sized for the tokenizer and corpus, its weights from
    `source` (default --model_checkpoint): a save_pretrained artifact
    directory of either package (its position table grown to `seq_len`
    when the corpus pads longer), a locally cached HF checkpoint, or a
    preset name; random weights from `cfg.seed` otherwise (the --test
    smoke model of 2 layers of width 32, or the preset with its
    embedding sized to the tokenizer). `require_load` (--finetune)
    turns the random fallback into FileNotFoundError. A loaded
    embedding smaller than the tokenizer grows to it. --remat applies
    whatever the weights' origin."""
    vocab = len(tokenizer)
    key = prng.PRNGKey(cfg.seed)
    source = source or cfg.model_checkpoint
    loaded = load_pretrained_dir(source, key=key)
    if loaded is not None:
        pretrained, gcfg = loaded
        if seq_len > gcfg.n_positions:
            pretrained = resize_position_embeddings(
                pretrained, seq_len, key=key,
                initializer_range=gcfg.initializer_range)
            gcfg = gcfg.replace(n_positions=seq_len)
    elif require_load:
        gcfg = PRESETS["gpt2"].replace(
            n_positions=max(PRESETS["gpt2"].n_positions, seq_len))
        pretrained = try_load_pretrained(source, gcfg, key=key)
        if pretrained is None:
            raise FileNotFoundError(
                f"--finetune: no loadable artifact at {source!r} (expected "
                "config.json + pytorch_model.bin/.npz from a previous "
                "run's save_pretrained, or a local HF checkpoint)")
    elif cfg.do_test:
        gcfg = GPT2Config(vocab_size=vocab, n_positions=max(seq_len, 8),
                          n_embd=32, n_layer=2, n_head=2)
        pretrained = None
    else:
        base = PRESETS.get(source, PRESETS["gpt2"])
        gcfg = base.replace(n_positions=max(base.n_positions, seq_len))
        pretrained = try_load_pretrained(source, gcfg, key=key)
        if pretrained is None:
            gcfg = gcfg.replace(vocab_size=vocab)
    gcfg = gcfg.replace(remat=cfg.do_remat)
    if pretrained is None:
        return GPT2DoubleHeads(gcfg, seed=cfg.seed)
    if vocab > gcfg.vocab_size:
        # special-token embedding resize (reference :101-112)
        pretrained = resize_token_embeddings(pretrained, vocab, key=key)
        gcfg = gcfg.replace(vocab_size=vocab)
    module = GPT2DoubleHeads(gcfg, seed=cfg.seed)
    from_jax_params(module, pretrained)
    return module


def finetune_source(cfg: Config) -> str:
    """Where the weights come from: --finetune swaps --model_checkpoint
    for --finetune_path (reference gpt2_train.py:270-272), under --test
    only when a saved artifact is there."""
    if cfg.do_finetune and (
            not cfg.do_test
            or any(os.path.isfile(os.path.join(cfg.finetune_path, f))
                   for f in ("pytorch_model.bin", "pytorch_model.npz"))):
        return cfg.finetune_path
    return cfg.model_checkpoint


def build(cfg: Config, tokenizer, device="cuda",
          synthetic_examples: Optional[Tuple[int, int, int]] = None,
          layout=None):
    """Loaders, model, optimizer and LR scheduler for `cfg`: what main()
    wires before it calls train_gpt2(). Under --model_parallel > 1 the
    losses are tp-wrapped (parallel/tp.py) on the tensor-parallel
    layout; under torch.distributed the model takes the default layout
    (or `layout`) and the loaders feed the rank's rows."""
    if layout is None and (cfg.model_parallel > 1 or mh.is_distributed()):
        layout = default_layout(cfg)
        if cfg.model_parallel > 1 and mh.is_coordinator():
            print(f"tensor parallel: mesh {dict(layout.shape)}")
    train_loader, val_loader = get_data_loaders(
        cfg, tokenizer, synthetic_examples,
        val_shards=1 if layout is None else layout.clients)
    # each split pads to its own corpus max; the position table must
    # cover both
    seq_len = max(train_loader.dataset.seq_len, val_loader.dataset.seq_len)
    source = finetune_source(cfg)
    module = build_model_and_params(
        cfg, tokenizer, seq_len, source=source,
        require_load=cfg.do_finetune and source == cfg.finetune_path)
    loss_train = make_compute_loss_train(module, cfg)
    loss_val = make_compute_loss_val(module)
    if layout is not None and cfg.model_parallel > 1:
        loss_train = tp_loss(loss_train, layout)
        loss_val = tp_loss(loss_val, layout)
    model = FedModel(module, loss_train, cfg, loss_val=loss_val,
                     device=device,
                     num_clients=train_loader.dataset.num_clients,
                     layout=layout)
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
    spe = train_loader.steps_per_epoch
    lr = cfg.lr_scale if cfg.lr_scale is not None else DEFAULT_LR
    schedule = PiecewiseLinear([0, cfg.num_epochs * spe], [lr, 0.0])
    lr_scheduler = LambdaLR(opt, lr_lambda=schedule)
    return model, opt, lr_scheduler, train_loader, val_loader


def _ckpt_path(cfg: Config) -> str:
    return os.path.join(cfg.checkpoint_path, "gpt2")


def run(model: FedModel, opt: FedOptimizer, lr_scheduler, train_loader,
        cfg: Config, log_dir: str, logger=None,
        timer: Optional[Timer] = None,
        on_round: Optional[Callable[[int, list], None]] = None) -> bool:
    """What main() does around train_gpt2(): --resume, the telemetry
    session (a numeric trip rolls back to the newest finite checkpoint
    and re-enters train_gpt2, persist.train_with_rollback),
    --checkpoint; the session is closed (`run_end`) whatever
    happens."""
    fallbacks = []
    if cfg.resume:
        persist.resume(model, lr_scheduler, _ckpt_path(cfg), fallbacks,
                       cfg.journal_path)
    tele = persist.start_telemetry(model, cfg, log_dir, "gpt2_train",
                                   fallbacks)
    ok = False
    try:
        ok = persist.train_with_rollback(
            lambda: train_gpt2(model, opt, lr_scheduler, train_loader, cfg,
                               logger=logger, timer=timer,
                               on_round=on_round, log_dir=log_dir),
            model, lr_scheduler, _ckpt_path(cfg), cfg, tele)
        if cfg.do_checkpoint:
            persist.checkpoint_final(model, lr_scheduler, _ckpt_path(cfg),
                                     cfg)
    finally:
        persist.close(model, tele, ok)
    return ok


def _ckpt_path(cfg: Config) -> str:
    return os.path.join(cfg.checkpoint_path, "gpt2")


def main(argv=None) -> bool:
    """The CLI. Under --multihost the rank joins its grid first
    (multihost.initialize: nccl on the card, gloo on the CPU)."""
    cfg = parse_args(default_lr=DEFAULT_LR, argv=argv)
    device = cfg.device
    if cfg.multihost:
        # before the model touches a device: the rank's card
        mh.initialize_from_config(cfg)
        device = mh.rank_device(cfg.device)
    if cfg.do_test:
        # smoke shrink of the compression geometry
        cfg = cfg.replace(num_rows=1, num_cols=1000, k=10, num_blocks=1)
    coord = mh.is_coordinator()
    if coord:
        print(cfg)
    timer = Timer()
    np.random.seed(cfg.seed)
    tokenizer = make_tokenizer(cfg.model_checkpoint,
                               fallback_vocab=500 if cfg.do_test else 5000)
    model, opt, lr_scheduler, train_loader, val_loader = build(
        cfg, tokenizer, device=device)
    # only the coordinator makes a run directory and writes artifacts
    log_dir = make_logdir(cfg) if coord else ""
    if coord:
        print("Steps per epoch", train_loader.steps_per_epoch)
        print(f"Finished initializing in {timer():.2f} seconds")
    if cfg.do_finetune:
        # --finetune evaluates the loaded artifact and trains nothing
        # (the reference's and the JAX driver's contract)
        tele = persist.start_telemetry(model, model.cfg, log_dir,
                                       "gpt2_train")
        try:
            test_gpt2(model, val_loader, timer=timer)
        finally:
            if tele is not None:
                tele.close(ok=True)
        model.finalize()
        return True
    ok = run(model, opt, lr_scheduler, train_loader, model.cfg, log_dir,
             timer=timer)
    # the final server state beside the run's artifacts, as the JAX
    # driver writes it, and the HF-style artifact: tokenizer + config +
    # weights (the coordinator's; every rank holds the same weights)
    save_checkpoint(os.path.join(log_dir, "gpt2"), model.server,
                    scheduler_step=lr_scheduler.step_count)
    module = model.module
    load_flat(module, model.ps_weights)
    if coord:
        save_pretrained(log_dir, to_jax_params(module), module.cfg,
                        tokenizer)
    test_gpt2(model, val_loader, timer=timer)
    model.finalize()
    return ok


def cli() -> None:
    raise SystemExit(0 if main() else 1)


if __name__ == "__main__":
    cli()
