"""Server-side aggregation: the port of
commefficient_tpu/federated/server.py for the ported modes (sketch,
uncompressed).

Same helper signature as the JAX package,
`(gradient, Vvelocity, Verror, cfg, lr) -> ServerUpdate`, and the same
`alive` gate: a round in which no client survived leaves the state
untouched and applies a zero update.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.ops.sketch import (
    CSVec, cached_sketch, scatter_drop,
)


class ServerUpdate(NamedTuple):
    """update: dense [D] weight update (the server applies w -= update);
    Vvelocity / Verror: new server momentum / error state; velocity_mask:
    None in the ported modes (true_topk's client momentum masking)."""
    update: torch.Tensor
    Vvelocity: torch.Tensor
    Verror: torch.Tensor
    velocity_mask: Optional[torch.Tensor]


def args2sketch(cfg: Config) -> CSVec:
    """The round's sketch geometry (seed 42, as in the JAX package)."""
    return cached_sketch(cfg.grad_size, cfg.num_cols, cfg.num_rows, 42)


def get_server_update(gradient: torch.Tensor, Vvelocity: torch.Tensor,
                      Verror: torch.Tensor, cfg: Config, lr,
                      alive: Optional[torch.Tensor] = None
                      ) -> ServerUpdate:
    """Dispatch on cfg.mode through its Compressor plugin. `alive`: an
    optional boolean scalar tensor; False gates the result to a no-op
    (zero update, state passed through bit-exactly)."""
    upd = cfg.compressor.decode(cfg, gradient, Vvelocity, Verror, lr)
    if alive is None:
        return upd
    return ServerUpdate(
        update=torch.where(alive, upd.update, torch.zeros_like(upd.update)),
        Vvelocity=torch.where(alive, upd.Vvelocity, Vvelocity),
        Verror=torch.where(alive, upd.Verror, Verror),
        velocity_mask=(None if upd.velocity_mask is None
                       else torch.where(alive, upd.velocity_mask,
                                        torch.ones_like(upd.velocity_mask))))


def _uncompressed(gradient, Vvelocity, Verror, cfg: Config,
                  lr) -> ServerUpdate:
    rho = cfg.virtual_momentum
    Vvelocity = gradient + rho * Vvelocity
    return ServerUpdate(Vvelocity * lr, Vvelocity, Verror, None)


def _sketched(sketched_grad, Vvelocity, Verror, cfg: Config,
              lr) -> ServerUpdate:
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

    if sketch._threshold_decode:
        update = sketch.decode_topk_dense(decode_table, k=cfg.k)
        sketched_update = sketch.encode(update)
    else:
        idx, vals = sketch.decode_topk_sparse(decode_table, k=cfg.k)
        update = scatter_drop(cfg.grad_size, idx, vals)
        sketched_update = sketch.encode_k_sparse(idx, vals, dense=update)

    not_sent = (sketched_update == 0).to(Vvelocity.dtype)
    if cfg.error_type == "virtual":
        Verror = Verror * not_sent
    Vvelocity = Vvelocity * not_sent
    return ServerUpdate(update * lr, Vvelocity, Verror, None)
