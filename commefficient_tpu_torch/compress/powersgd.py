"""PowerSGD: rank-r power-iteration compression, the port of
commefficient_tpu/compress/powersgd.py.

Vogels et al. (PAPERS.md): reshape the flat [D] update into a
near-square [m, n] matrix M and run one warm-started power iteration,

    P = M @ Q_prev          # [m, r]
    P_hat = orth(P)         # modified Gram-Schmidt
    Q_new = M^T @ P_hat     # [n, r]

transmit the (m + n) * r factor floats and keep the residual
M - P_hat @ Q_new^T in the client's error row. Q_new is per-client
state: it rides the [population, D] velocity row (validate() forces
local_momentum == 0, so the row is free), so the cohort gather and
scatter, the `crows_*` checkpoint payload and the screened/dropped
keep-mask merge of federated/round.py carry it unchanged.

As in the JAX engine, each client decodes its own low-rank
approximation to a dense [D] vector before the cohort sum; the
accountant bills the (m + n) * r factor floats.

A fresh client (all-zero Q row) starts from a normal draw on the
"powersgd" PRNG domain folded into its round key (ops/prng.py), so
replay and resume are bitwise.

The two GEMMs are plain `torch.matmul`: the JAX package computes them
outside any Pallas kernel. TF32 stays off (device.py).
"""
from __future__ import annotations

import math

import torch

from commefficient_tpu_torch.compress.base import Compressor
from commefficient_tpu_torch.ops import prng
from commefficient_tpu_torch.utils.faults import DOMAINS


def factor_shape(d: int):
    """[m, n] for a flat [d] update: n = isqrt(d), m = ceil(d / n), so
    m * n >= d >= n * n and the rank bound is n."""
    n = max(1, math.isqrt(d))
    m = -(-d // n)
    return m, n


def orthonormalize(P: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Column-wise modified Gram-Schmidt with an eps-guarded norm, the
    columns in order: a degenerate column comes out as a tiny-norm
    direction, never NaN."""
    cols = []
    for i in range(P.shape[1]):
        c = P[:, i]
        for q in cols:
            c = c - torch.dot(q, c) * q
        c = c / torch.clamp(torch.linalg.vector_norm(c), min=eps)
        cols.append(c)
    return torch.stack(cols, dim=1)


class PowerSGDCompressor(Compressor):
    name = "powersgd"

    # ---- static specs -------------------------------------------------
    def state_shape(self, cfg):
        # the decoded aggregate rides plain dense virtual momentum
        return (cfg.grad_size,)

    def wire_floats(self, cfg) -> int:
        m, n = factor_shape(cfg.grad_size)
        return (m + n) * cfg.powersgd_rank

    def has_errors(self, cfg) -> bool:
        return True   # validate() forces error_type == "local"

    def has_velocities(self, cfg) -> bool:
        return True   # the warm-started Q factor rides this row

    def validate(self, cfg) -> None:
        if cfg.powersgd_rank < 1:
            raise ValueError(
                f"powersgd_rank={cfg.powersgd_rank} must be >= 1")
        if cfg.error_type != "local":
            raise ValueError(
                "powersgd requires --error_type local: the low-rank "
                "residual M - P Q^T is per-client error feedback "
                "(compress/powersgd.py)")
        if cfg.local_momentum != 0:
            raise ValueError(
                "powersgd requires local_momentum == 0: the per-client "
                "velocity block carries the warm-started Q factor "
                "(compress/powersgd.py)")
        if cfg.grad_size > 0:
            m, n = factor_shape(cfg.grad_size)
            if cfg.powersgd_rank > n:
                raise ValueError(
                    f"powersgd_rank={cfg.powersgd_rank} exceeds the "
                    f"rank bound min(m, n)={n} of the "
                    f"[{m}, {n}] factorization of grad_size="
                    f"{cfg.grad_size}")

    # ---- round seams --------------------------------------------------
    def residual(self, cfg, to_transmit, error, velocity, key=None):
        """`to_transmit` is the error accumulator (error_type local,
        no momentum): factor it, transmit the low-rank approximation,
        keep the residual as the error carry and Q_new as the velocity
        carry."""
        D = cfg.grad_size
        m, n = factor_shape(D)
        r = cfg.powersgd_rank
        M = torch.nn.functional.pad(to_transmit, (0, m * n - D)).reshape(
            m, n)
        q_flat = velocity[:n * r]
        q_init = prng.normal(prng.fold_in(key, DOMAINS["powersgd"]),
                             (n, r), device=to_transmit.device)
        # a fresh client's Q row is all zero (`where`, no host read)
        fresh = torch.sum(q_flat * q_flat) == 0
        Q_prev = torch.where(fresh, q_init, q_flat.reshape(n, r))

        P_hat = orthonormalize(M @ Q_prev)            # [m, r]
        Q_new = M.T @ P_hat                           # [n, r]
        approx = (P_hat @ Q_new.T).reshape(-1)[:D]    # the client decode

        new_error = to_transmit - approx
        new_velocity = torch.cat([Q_new.reshape(-1),
                                  velocity.new_zeros(velocity.shape[0]
                                                     - n * r)])
        return approx, new_error, new_velocity

    def decode(self, cfg, gradient, Vvelocity, Verror, lr, key=None):
        # the clients decoded their factors already: dense virtual
        # momentum over the aggregate
        from commefficient_tpu_torch.federated.server import ServerUpdate
        Vvelocity = gradient + cfg.virtual_momentum * Vvelocity
        return ServerUpdate(Vvelocity * lr, Vvelocity, Verror, None)
