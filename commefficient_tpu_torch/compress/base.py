"""The Compressor plugin interface: the port of
commefficient_tpu/compress/base.py.

A Compressor packages what the round engine needs to know about one
client->server update scheme:

static specs (host-side config math): `state_shape`, `wire_floats`,
`wire_bytes`, `has_errors`, `has_velocities`, `validate`;

the four seams of the round, each the identity by default:
  * `encode(cfg, grad, key)` — per client, the mean gradient -> the
    wire quantity;
  * `residual(cfg, to_transmit, error, velocity, key)` — per client,
    after count scaling: wire payload plus the error/velocity carries
    (local_topk's sparsify-and-mask, PowerSGD's low-rank factors,
    dp_sketch's sensitivity clip);
  * `post_aggregate(cfg, transmit, key)` — once a round on the cohort
    sum;
  * `decode(cfg, gradient, Vvelocity, Verror, lr, key)` — the server
    step, returning a federated.server.ServerUpdate.

`key` is a threefry key (ops/prng.py): the client's, the round's or
the server's, as in the JAX engine.

`sketch_like` marks a scheme whose wire quantity is the [r, c]
count-sketch table, `local_sgd` one that trains several local steps.
"""
from __future__ import annotations

from typing import Tuple


class Compressor:
    name: str = ""
    local_sgd: bool = False
    sketch_like: bool = False

    # ---- static specs -------------------------------------------------
    def state_shape(self, cfg) -> Tuple[int, ...]:
        if self.sketch_like:
            return (cfg.num_rows, cfg.num_cols)
        return (cfg.grad_size,)

    def wire_floats(self, cfg) -> int:
        raise NotImplementedError

    def wire_bytes(self, cfg) -> int:
        return 4 * self.wire_floats(cfg)

    def has_errors(self, cfg) -> bool:
        return cfg.error_type == "local"

    def has_velocities(self, cfg) -> bool:
        return cfg.local_momentum > 0

    def validate(self, cfg) -> None:
        """Raise ValueError on config combinations this scheme does not
        support."""

    # ---- round seams --------------------------------------------------
    def encode(self, cfg, grad, key=None):
        return grad

    def residual(self, cfg, to_transmit, error, velocity, key=None):
        return to_transmit, error, velocity

    def post_aggregate(self, cfg, transmit, key=None):
        return transmit

    def decode(self, cfg, gradient, Vvelocity, Verror, lr, key=None):
        raise NotImplementedError
