"""Server-side aggregation: the port of
commefficient_tpu/federated/server.py for the ported modes (sketch,
true_topk, local_topk, fedavg, uncompressed).

Same helper signature as the JAX package,
`(gradient, Vvelocity, Verror, cfg, lr, key) -> ServerUpdate` (`key`:
the server's threefry key, ops/prng.py, for server-side DP noise), and
the same `alive` gate: a round in which no client survived leaves the state
untouched and applies a zero update.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.ops.flat import dp_noise, masked_topk
from commefficient_tpu_torch.ops.sketch import (
    CSVec, cached_sketch, scatter_drop,
)
from commefficient_tpu_torch.telemetry.trace import TRACE


class ServerUpdate(NamedTuple):
    """update: dense [D] weight update (the server applies w -= update);
    Vvelocity / Verror: new server momentum / error state; velocity_mask:
    [D] not-sent mask for the participants' local velocity rows
    (true_topk with local momentum), else None."""
    update: torch.Tensor
    Vvelocity: torch.Tensor
    Verror: torch.Tensor
    velocity_mask: Optional[torch.Tensor]


def args2sketch(cfg: Config) -> CSVec:
    """The round's sketch geometry (seed 42, as in the JAX package)."""
    return cached_sketch(cfg.grad_size, cfg.num_cols, cfg.num_rows, 42)


def get_server_update(gradient: torch.Tensor, Vvelocity: torch.Tensor,
                      Verror: torch.Tensor, cfg: Config, lr,
                      key: Optional[torch.Tensor] = None,
                      alive: Optional[torch.Tensor] = None
                      ) -> ServerUpdate:
    """Dispatch on cfg.mode through its Compressor plugin. `key`: the
    server's threefry key (needed by `--dp --dp_mode server`). `alive`:
    an optional boolean scalar tensor; False gates the result to a
    no-op (zero update, state passed through bit-exactly)."""
    upd = cfg.compressor.decode(cfg, gradient, Vvelocity, Verror, lr, key)
    if alive is None:
        return upd
    return ServerUpdate(
        update=torch.where(alive, upd.update, torch.zeros_like(upd.update)),
        Vvelocity=torch.where(alive, upd.Vvelocity, Vvelocity),
        Verror=torch.where(alive, upd.Verror, Verror),
        velocity_mask=(None if upd.velocity_mask is None
                       else torch.where(alive, upd.velocity_mask,
                                        torch.ones_like(upd.velocity_mask))))


def _fedavg(avg_update, Vvelocity, Verror, cfg: Config,
            lr, key=None) -> ServerUpdate:
    """`lr` is ignored: the clients already applied it in their local
    steps, and the averaged weight delta is applied as it is."""
    rho = cfg.virtual_momentum
    Vvelocity = avg_update + rho * Vvelocity
    return ServerUpdate(Vvelocity, Vvelocity, Verror, None)


def _true_topk(gradient, Vvelocity, Verror, cfg: Config,
               lr, key=None) -> ServerUpdate:
    """Top-k of the virtual error, then error feedback and momentum
    factor masking at the sent coordinates; with local momentum the
    participants' velocity rows are masked there too (the round applies
    `velocity_mask`)."""
    rho = cfg.virtual_momentum
    Vvelocity = gradient + rho * Vvelocity
    Verror = Verror + Vvelocity
    update = masked_topk(Verror, k=cfg.k)
    not_sent = (update == 0).to(Verror.dtype)
    Verror = Verror * not_sent
    Vvelocity = Vvelocity * not_sent
    vel_mask = not_sent if cfg.local_momentum > 0 else None
    return ServerUpdate(update * lr, Vvelocity, Verror, vel_mask)


def _local_topk(local_topk_grad, Vvelocity, Verror, cfg: Config,
                lr, key=None) -> ServerUpdate:
    """Virtual momentum over the already sparsified cohort sum; no
    virtual error."""
    rho = cfg.virtual_momentum
    Vvelocity = local_topk_grad + rho * Vvelocity
    return ServerUpdate(Vvelocity * lr, Vvelocity, Verror, None)


def _uncompressed(gradient, Vvelocity, Verror, cfg: Config,
                  lr, key=None) -> ServerUpdate:
    """Momentum SGD; with `--dp --dp_mode server` the step (not the
    momentum state) carries N(0, noise_multiplier) noise."""
    rho = cfg.virtual_momentum
    Vvelocity = gradient + rho * Vvelocity
    grad = Vvelocity
    if cfg.do_dp and cfg.dp_mode == "server":
        grad = grad + dp_noise(key, grad.shape, cfg.noise_multiplier,
                               device=grad.device)
    return ServerUpdate(grad * lr, Vvelocity, Verror, None)


def _sketched(sketched_grad, Vvelocity, Verror, cfg: Config,
              lr, key=None) -> ServerUpdate:
    """FetchSGD's server step in table space: momentum, virtual error,
    the median estimate of every coordinate (kernel K2 on the card),
    top-k, a re-sketch of the k-sparse update, and zeroing of the cells
    it landed in (zeroed, not subtracted, as the reference does)."""
    rho = cfg.virtual_momentum
    sketch = args2sketch(cfg)
    Vvelocity = sketched_grad + rho * Vvelocity
    if cfg.error_type == "virtual":
        Verror = Verror + Vvelocity
        decode_table = Verror
    else:  # "none": decode straight from the momentum table
        decode_table = Vvelocity

    with TRACE.span("decode"):
        if sketch._threshold_decode:
            update = sketch.decode_topk_dense(decode_table, k=cfg.k)
            sketched_update = sketch.encode(update)
        else:
            idx, vals = sketch.decode_topk_sparse(decode_table, k=cfg.k)
            update = scatter_drop(cfg.grad_size, idx, vals)
            sketched_update = sketch.encode_k_sparse(idx, vals,
                                                     dense=update)

    not_sent = (sketched_update == 0).to(Vvelocity.dtype)
    if cfg.error_type == "virtual":
        Verror = Verror * not_sent
    Vvelocity = Vvelocity * not_sent
    return ServerUpdate(update * lr, Vvelocity, Verror, None)
