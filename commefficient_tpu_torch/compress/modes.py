"""The five classic modes as Compressor plugins: sketch, true_topk,
local_topk, fedavg and uncompressed (the port of
commefficient_tpu/compress/modes.py; powersgd and dp_sketch have
modules of their own).

The server helpers are imported inside `decode`: federated/server
imports config, and config's spec properties import this package.
"""
from __future__ import annotations

from commefficient_tpu_torch.compress.base import Compressor
from commefficient_tpu_torch.ops.flat import clip_table_to_l2, masked_topk
from commefficient_tpu_torch.ops.kernels.quant import wire_table_bytes


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
        # at the wire dtype, int8's per-row scales included
        return wire_table_bytes(cfg.num_rows, cfg.num_cols,
                                cfg.sketch_table_dtype)

    def encode(self, cfg, grad, key=None):
        if cfg.defer_sketch_encode:
            # linearity: the round encodes the cohort's SUM once
            return grad
        sketch = _fserver().args2sketch(cfg)
        table = sketch.encode(grad)
        if cfg.max_grad_norm is not None:
            table = clip_table_to_l2(table, sketch.l2estimate(table),
                                     cfg.max_grad_norm)
        return table

    def decode(self, cfg, gradient, Vvelocity, Verror, lr, key=None):
        return _fserver()._sketched(gradient, Vvelocity, Verror, cfg,
                                    lr, key)


class TrueTopkCompressor(Compressor):
    """Exact top-k of the summed dense gradient, selected at the server
    with virtual momentum/error feedback."""
    name = "true_topk"

    def wire_floats(self, cfg) -> int:
        return cfg.grad_size

    def decode(self, cfg, gradient, Vvelocity, Verror, lr, key=None):
        return _fserver()._true_topk(gradient, Vvelocity, Verror, cfg,
                                     lr, key)


class LocalTopkCompressor(Compressor):
    """Per-client top-k sparsification with local error feedback and
    momentum factor masking."""
    name = "local_topk"

    def wire_floats(self, cfg) -> int:
        return cfg.k

    def residual(self, cfg, to_transmit, error, velocity, key=None):
        to_transmit = masked_topk(to_transmit, k=cfg.k)
        not_sent = (to_transmit == 0).to(to_transmit.dtype)
        if cfg.error_type == "local":
            error = error * not_sent           # error feedback
        if cfg.local_momentum > 0:
            velocity = velocity * not_sent     # momentum factor masking
        return to_transmit, error, velocity

    def decode(self, cfg, gradient, Vvelocity, Verror, lr, key=None):
        return _fserver()._local_topk(gradient, Vvelocity, Verror, cfg,
                                      lr, key)


class FedavgCompressor(Compressor):
    """Uncompressed multi-step local SGD transmitting the weighted
    weight delta."""
    name = "fedavg"
    local_sgd = True

    def wire_floats(self, cfg) -> int:
        return cfg.grad_size

    def decode(self, cfg, gradient, Vvelocity, Verror, lr, key=None):
        return _fserver()._fedavg(gradient, Vvelocity, Verror, cfg,
                                  lr, key)


class UncompressedCompressor(Compressor):
    """Dense single-step SGD, the no-compression upper bound."""
    name = "uncompressed"

    def wire_floats(self, cfg) -> int:
        return cfg.grad_size

    def decode(self, cfg, gradient, Vvelocity, Verror, lr, key=None):
        return _fserver()._uncompressed(gradient, Vvelocity, Verror, cfg,
                                        lr, key)
