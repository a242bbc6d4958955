"""Client-side computation: the port of
commefficient_tpu/federated/client.py.

loss_fn contract (the workload callback, as in the JAX package):
    loss_fn(params, batch_tuple, mask) -> (masked-mean loss, metrics)
where `params` is the {name: tensor} dict `unravel` gives (for
`torch.func.functional_call`), `batch_tuple` one client's padded batch
and `mask` its [B] float validity mask. Every client quantity is
computed in the flat-vector space of ops/flat.py.

The transmitted quantity is scaled by the client's valid example
count, so the server's divide by the cohort's example total is exact
(reference fed_worker.py:190).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.ops.flat import (
    clip_to_l2, dp_noise, global_norm_clip,
)

LossFn = Callable[[dict, Tuple[torch.Tensor, ...], torch.Tensor],
                  Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]]


class ClientResult(NamedTuple):
    transmit: torch.Tensor       # [D] vector or [r, c] table
    error: torch.Tensor          # updated local error state (or dummy)
    velocity: torch.Tensor       # updated local velocity state (or dummy)
    loss: torch.Tensor           # masked-mean loss over the client batch
    metrics: Tuple[torch.Tensor, ...]
    num_examples: torch.Tensor   # valid example count (f32 scalar)


def _cast(x: torch.Tensor, dtype) -> torch.Tensor:
    """x in `dtype` when x is floating (the JAX package's `_cast_tree`
    leaf rule); integer and boolean tensors pass unchanged."""
    return x.to(dtype) if x.is_floating_point() else x


def _compute_in(params: dict, batch, compute_dtype):
    """The parameters and batch a model body sees: cast to
    `compute_dtype` (--bf16) leaf by leaf, or as they are. The cast is
    differentiable, so the gradient reaches the float32 flat vector in
    float32. The validity mask is never cast."""
    if compute_dtype is None:
        return params, batch
    return ({k: _cast(v, compute_dtype) for k, v in params.items()},
            tuple(_cast(x, compute_dtype) for x in batch))


def _loss_out(loss, metrics, compute_dtype):
    """Loss and metrics brought back to float32 after a `compute_dtype`
    body (float32 and float64 bodies return theirs as they are)."""
    if compute_dtype is None:
        return loss, metrics
    return loss.float(), tuple(m.float() for m in metrics)


def make_flat_loss_fn(loss_fn: LossFn, unravel: Callable,
                      compute_dtype=None):
    """loss_fn lifted to the flat weight vector:
    flat_loss(vec, batch, mask) -> (loss, metrics). Differentiable in
    `vec` when it requires grad. Consecutive calls on the same `vec`
    object (the cohort's clients in fused_shard_grads) share one
    unravel, so the backward splits the gradient once, not per client.
    `compute_dtype` (torch.bfloat16 under --bf16) is the type the model
    body computes in; each call casts the parameters anew, so each
    client's bf16 gradient is summed into the float32 vector."""
    last = [None, None]

    def flat_loss(vec, batch, mask):
        if last[0] is not vec:
            last[:] = [vec, unravel(vec)]
        params, batch = _compute_in(last[1], batch, compute_dtype)
        return _loss_out(*loss_fn(params, batch, mask), compute_dtype)
    return flat_loss


def make_flat_grad_fn(loss_fn: LossFn, unravel: Callable,
                      compute_dtype=None):
    """flat_grad(vec, batch, mask) -> (loss, metrics, grad [D]), the
    gradient taken with respect to the float32 flat vector, the body
    computed in `compute_dtype` when it is given."""
    def flat_grad(weights, batch, mask):
        w = weights.detach().requires_grad_(True)
        params, b = _compute_in(unravel(w), batch, compute_dtype)
        loss, metrics = _loss_out(*loss_fn(params, b, mask), compute_dtype)
        grad, = torch.autograd.grad(loss, w)
        return (loss.detach(), tuple(m.detach() for m in metrics), grad)
    return flat_grad


def _microbatch_shape(batch_size: int, microbatch_size: int):
    mb = (batch_size if microbatch_size <= 0
          else min(microbatch_size, batch_size))
    return -(-batch_size // mb), mb


def _microbatches(batch, mask, n_mb: int, mb: int):
    """Pad [B, ...] tensors to n_mb * mb and cut them into n_mb
    microbatches."""
    B = mask.shape[0]
    pad = n_mb * mb - B

    def fold(x):
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return x.reshape((n_mb, mb) + tuple(x.shape[1:]))

    folded = [fold(x) for x in batch]
    mmask = fold(mask)
    return [(tuple(f[i] for f in folded), mmask[i]) for i in range(n_mb)]


def forward_grad(flat_grad_fn, weights: torch.Tensor, batch,
                 mask: torch.Tensor, cfg: Config, key=None,
                 compute_grad: bool = True,
                 grad_mask: Optional[torch.Tensor] = None):
    """Microbatched forward(/backward) over one client's padded batch.
    Returns (g, loss, metrics, count): g the compressed mean gradient
    (None when compute_grad is False, and then `flat_grad_fn` is a
    loss-only callable, see make_flat_loss_fn), loss and metrics masked
    means, count the valid example count. `key` is the client's
    threefry key (ops/prng.py), which `--dp --dp_mode worker` draws its
    noise from.

    The mean gradient then goes through the JAX package's steps in its
    order: `grad_mask` (0 at frozen coordinates, --finetune: they take
    no gradient, no weight decay, no share of a clipping norm and no
    DP noise), `--max_grad_norm`'s global-norm clip (not in sketch
    mode, which clips the table), weight decay, `--dp`'s clip to
    l2_norm_clip and worker noise, and the mode's encode."""
    n_mb, mb = _microbatch_shape(mask.shape[0], cfg.microbatch_size)
    grad_sum = torch.zeros_like(weights) if compute_grad else None
    loss_sum = weights.new_zeros(())
    metric_sums = None
    for b, m in _microbatches(batch, mask, n_mb, mb):
        count = m.sum()
        if compute_grad:
            loss, metrics, grad = flat_grad_fn(weights, b, m)
            grad_sum = grad_sum + grad * count
        else:
            with torch.no_grad():
                loss, metrics = flat_grad_fn(weights, b, m)
        loss_sum = loss_sum + loss * count
        weighted = [v * count for v in metrics]
        metric_sums = (weighted if metric_sums is None
                       else [a + v for a, v in zip(metric_sums, weighted)])

    total = mask.sum()
    denom = torch.clamp(total, min=1.0)
    loss = loss_sum / denom
    metrics = tuple(s / denom for s in metric_sums)
    if not compute_grad:
        return None, loss, metrics, total

    # mean over valid examples: the gradient scale does not depend on
    # microbatch_size
    grad = grad_sum / denom
    if grad_mask is not None:
        grad = grad * grad_mask
    if cfg.max_grad_norm is not None and cfg.mode != "sketch":
        grad = global_norm_clip(grad, cfg.max_grad_norm)
    # weight decay, divided by num_workers so the summed transmission
    # applies it once (reference utils.py:254-259)
    if cfg.weight_decay != 0:
        wd_term = (cfg.weight_decay / cfg.num_workers) * weights
        if grad_mask is not None:
            wd_term = wd_term * grad_mask
        grad = grad + wd_term
    if cfg.do_dp:
        grad = clip_to_l2(grad, cfg.l2_norm_clip)
        if cfg.dp_mode == "worker":
            grad = grad + dp_noise(key, grad.shape, cfg.noise_multiplier,
                                   scale=math.sqrt(cfg.num_workers),
                                   device=grad.device)
        if grad_mask is not None:
            grad = grad * grad_mask
    return cfg.compressor.encode(cfg, grad, key), loss, metrics, total


def fused_shard_grads(flat_loss_fn, weights: torch.Tensor, batch,
                      mask: torch.Tensor, cfg: Config,
                      grad_mask: Optional[torch.Tensor] = None,
                      survivors: Optional[torch.Tensor] = None):
    """One backward over the whole cohort (Config.fused_client_backward
    guarantees it equals the sum of per-client local_step transmits):

        sum_c transmit_c = d/dw [ sum_c count_c * mean_loss_c ]

    plus the weight-decay term every client adds as
    (wd / num_workers) * w before its count scaling.

    batch / mask are the cohort's [W, B, ...] tensors. The clients'
    forwards run one after another (each client's loss_fn sees only its
    own batch, so batch statistics stay per client) and one backward
    follows. `survivors` ([W] {0,1}) weights each client's term and
    count, so a dropped client adds exactly nothing; `grad_mask` zeroes
    frozen coordinates of the gradient and the weight-decay term.
    Returns (grad_sum [D], losses [W], metrics, counts [W]) with
    per-client masked-mean losses and metrics and survivor-weighted
    counts."""
    w = weights.detach().requires_grad_(True)
    W = mask.shape[0]
    losses, metrics = [], []
    for c in range(W):
        loss, mets = flat_loss_fn(w, tuple(x[c] for x in batch), mask[c])
        losses.append(loss)
        metrics.append(mets)
    losses = torch.stack(losses)
    counts = mask.sum(dim=1)
    if survivors is not None:
        counts = counts * survivors
    total = (losses * counts).sum()
    grad_sum, = torch.autograd.grad(total, w)
    if grad_mask is not None:
        grad_sum = grad_sum * grad_mask
    if cfg.weight_decay != 0:
        wd_term = ((cfg.weight_decay / cfg.num_workers)
                   * weights * counts.sum())
        if grad_mask is not None:
            wd_term = wd_term * grad_mask
        grad_sum = grad_sum + wd_term
    mets = tuple(torch.stack([m[i].detach() for m in metrics])
                 for i in range(len(metrics[0])))
    return grad_sum, losses.detach(), mets, counts


def local_step(flat_grad_fn, weights, batch, mask, error, velocity,
               cfg: Config, key=None,
               grad_mask: Optional[torch.Tensor] = None) -> ClientResult:
    """One client's single local step plus its compression bookkeeping
    (reference local_step, fed_worker.py:184-230); `key` is the
    client's threefry key, `grad_mask` forward_grad's."""
    g, loss, metrics, count = forward_grad(flat_grad_fn, weights, batch,
                                           mask, cfg, key,
                                           grad_mask=grad_mask)
    # the transmit sums over examples; the server divides by the
    # cohort's example total
    g = g * count
    if cfg.local_momentum > 0:
        velocity = g + cfg.local_momentum * velocity
    if cfg.error_type == "local":
        error = error + (velocity if cfg.local_momentum > 0 else g)
        to_transmit = error
    else:
        to_transmit = velocity if cfg.local_momentum > 0 else g
    # the plugin's residual seam: wire payload and the new carries
    to_transmit, error, velocity = cfg.compressor.residual(
        cfg, to_transmit, error, velocity, key)
    return ClientResult(to_transmit, error, velocity, loss, metrics, count)


def fedavg_step(flat_grad_fn, weights, batch, mask, cfg: Config,
                lr, grad_mask: Optional[torch.Tensor] = None,
                work: Optional[torch.Tensor] = None) -> ClientResult:
    """FedAvg: full local SGD over the client's whole padded dataset,
    transmitting the dataset-size-weighted weight delta (reference
    worker_loop fedavg branch, fed_worker.py:61-113).

    The dataset is cut into fedavg_batch_size batches and run through
    num_fedavg_epochs times, step s at lr * fedavg_lr_decay**s. Every
    step runs, an all-padding batch included: its gradient is the
    weight-decay term alone and its zero loss counts in the step mean,
    as in the JAX scan. Like the JAX package's fedavg_step, it applies
    neither `--dp` nor `--max_grad_norm`. `lr` is a float or a [D]
    per-parameter tensor; `grad_mask` zeroes frozen coordinates' local
    gradients (weight decay included).

    `work` (a scalar tensor in (0, 1], a straggler): only the first
    ceil(work * steps) steps apply; the later ones still run (as the
    JAX scan traces them) with their updates gated off. Loss and
    metrics are then means over the completed steps, and the delta is
    weighted by the examples processed, the dataset size times the
    completed share of the steps."""
    B = mask.shape[0]
    inner = (B if cfg.fedavg_batch_size == -1
             else min(cfg.fedavg_batch_size, B))
    n_batches = -(-B // inner)
    batches = _microbatches(batch, mask, n_batches, inner)
    steps = cfg.num_fedavg_epochs * n_batches
    live_steps = None if work is None else torch.ceil(work * steps)
    w = weights
    losses, metrics_seq, lives = [], [], []
    step = 0
    for _ in range(cfg.num_fedavg_epochs):
        for b, m in batches:
            loss, metrics, grad = flat_grad_fn(w, b, m)
            if cfg.weight_decay != 0:
                grad = grad + (cfg.weight_decay / cfg.num_workers) * w
            if grad_mask is not None:
                grad = grad * grad_mask
            decay = cfg.fedavg_lr_decay ** step
            if live_steps is None:
                w = w - grad * lr * decay
            else:
                live = (step < live_steps).to(w.dtype)
                w = w - grad * lr * decay * live
                lives.append(live)
            losses.append(loss)
            metrics_seq.append(metrics)
            step += 1
    if live_steps is None:
        # loss and metrics averaged over the local steps (reference
        # fed_worker.py:102-103)
        loss = torch.stack(losses).mean()
        metrics = tuple(torch.stack(m).mean() for m in zip(*metrics_seq))
        count = mask.sum()
    else:
        lives = torch.stack(lives)
        done = lives.sum()
        denom = torch.clamp(done, min=1.0)
        loss = (torch.stack(losses) * lives).sum() / denom
        metrics = tuple((torch.stack(m) * lives).sum() / denom
                        for m in zip(*metrics_seq))
        count = mask.sum() * (done / steps)
    delta = (weights - w) * count
    dummy = weights.new_zeros(())
    return ClientResult(delta, dummy, dummy, loss, metrics, count)
