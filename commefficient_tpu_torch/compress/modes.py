"""The five classic modes as Compressor plugins: sketch, true_topk,
local_topk, fedavg and uncompressed (the port of
commefficient_tpu/compress/modes.py; powersgd and dp_sketch are
ROADMAP.md Queue 1 item 9).

The server helpers are imported inside `decode`: federated/server
imports config, and config's spec properties import this package.
"""
from __future__ import annotations

from commefficient_tpu_torch.compress.base import Compressor
from commefficient_tpu_torch.ops.flat import masked_topk

# wire element size of the sketch table; only f32 is ported
_TABLE_ELEM_BYTES = {"f32": 4}


def _fserver():
    from commefficient_tpu_torch.federated import server as fserver
    return fserver


class SketchCompressor(Compressor):
    """FetchSGD count-sketch transport: [r, c] tables, linear
    aggregation, server-side top-k decode with virtual momentum/error
    in table space."""
    name = "sketch"
    sketch_like = True

    def wire_floats(self, cfg) -> int:
        return cfg.num_rows * cfg.num_cols

    def wire_bytes(self, cfg) -> int:
        return (cfg.num_rows * cfg.num_cols
                * _TABLE_ELEM_BYTES[cfg.sketch_table_dtype])

    def encode(self, cfg, grad):
        if cfg.defer_sketch_encode:
            # linearity: the round encodes the cohort's SUM once
            return grad
        return _fserver().args2sketch(cfg).encode(grad)

    def decode(self, cfg, gradient, Vvelocity, Verror, lr):
        return _fserver()._sketched(gradient, Vvelocity, Verror, cfg, lr)


class TrueTopkCompressor(Compressor):
    """Exact top-k of the summed dense gradient, selected at the server
    with virtual momentum/error feedback."""
    name = "true_topk"

    def wire_floats(self, cfg) -> int:
        return cfg.grad_size

    def decode(self, cfg, gradient, Vvelocity, Verror, lr):
        return _fserver()._true_topk(gradient, Vvelocity, Verror, cfg, lr)


class LocalTopkCompressor(Compressor):
    """Per-client top-k sparsification with local error feedback and
    momentum factor masking."""
    name = "local_topk"

    def wire_floats(self, cfg) -> int:
        return cfg.k

    def residual(self, cfg, to_transmit, error, velocity):
        to_transmit = masked_topk(to_transmit, k=cfg.k)
        not_sent = (to_transmit == 0).to(to_transmit.dtype)
        if cfg.error_type == "local":
            error = error * not_sent           # error feedback
        if cfg.local_momentum > 0:
            velocity = velocity * not_sent     # momentum factor masking
        return to_transmit, error, velocity

    def decode(self, cfg, gradient, Vvelocity, Verror, lr):
        return _fserver()._local_topk(gradient, Vvelocity, Verror, cfg, lr)


class FedavgCompressor(Compressor):
    """Uncompressed multi-step local SGD transmitting the weighted
    weight delta."""
    name = "fedavg"
    local_sgd = True

    def wire_floats(self, cfg) -> int:
        return cfg.grad_size

    def decode(self, cfg, gradient, Vvelocity, Verror, lr):
        return _fserver()._fedavg(gradient, Vvelocity, Verror, cfg, lr)


class UncompressedCompressor(Compressor):
    """Dense single-step SGD, the no-compression upper bound."""
    name = "uncompressed"

    def wire_floats(self, cfg) -> int:
        return cfg.grad_size

    def decode(self, cfg, gradient, Vvelocity, Verror, lr):
        return _fserver()._uncompressed(gradient, Vvelocity, Verror, cfg,
                                        lr)
