"""The ported modes as Compressor plugins: sketch and uncompressed
(the port of commefficient_tpu/compress/modes.py; true_topk,
local_topk and fedavg are ROADMAP.md Queue 1 item 6).

The server helpers are imported inside `decode`: federated/server
imports config, and config's spec properties import this package.
"""
from __future__ import annotations

from commefficient_tpu_torch.compress.base import Compressor

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


class UncompressedCompressor(Compressor):
    """Dense single-step SGD, the no-compression upper bound."""
    name = "uncompressed"

    def wire_floats(self, cfg) -> int:
        return cfg.grad_size

    def decode(self, cfg, gradient, Vvelocity, Verror, lr):
        return _fserver()._uncompressed(gradient, Vvelocity, Verror, cfg,
                                        lr)
