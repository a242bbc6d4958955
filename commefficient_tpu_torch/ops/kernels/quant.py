"""Quantized sketch-table wire transport (--sketch_table_dtype): the
port of commefficient_tpu/ops/kernels/quant.py.

The round applies `wire_roundtrip` to the cohort's summed [r, c] table
after the encode: the upload quantized at the sender and dequantized
before the server's decode. The accountant bills the bytes of the
quantized table (`wire_table_bytes`, Config.upload_bytes), int8's
per-row float32 scales included.

Quantization rounds to nearest even (`torch.round`, as `jnp.round`),
in the JAX order: round(table / scale), clip to +-127, cast, then
times the scale. The f32 wire returns its argument itself.

Plain PyTorch, as the JAX module is plain jnp by design: elementwise
work with no `pallas_call`, so no hand kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# wire dtype -> bytes per table element
TABLE_DTYPES = {"f32": 4, "bf16": 2, "int8": 1}

# the symmetric int8 range; the -128 code is unused
_INT8_MAX = 127.0


def table_elem_bytes(dtype: str) -> int:
    return TABLE_DTYPES[dtype]


def quantize_table(table: torch.Tensor, dtype: str
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(wire values, scales) of an [r, c] float32 table: scales is None
    for f32 and bf16, the [r, 1] per-row absmax / 127 for int8 (1 for
    an all-zero row, so it dequantizes to exact zeros)."""
    if dtype == "f32":
        return table, None
    if dtype == "bf16":
        return table.to(torch.bfloat16), None
    if dtype == "int8":
        absmax = table.abs().amax(dim=1, keepdim=True)
        scale = torch.where(absmax > 0, absmax / _INT8_MAX,
                            torch.ones_like(absmax))
        q = torch.clamp(torch.round(table / scale), -_INT8_MAX, _INT8_MAX)
        return q.to(torch.int8), scale
    raise ValueError(f"unknown sketch table dtype {dtype!r} "
                     f"(choices: {sorted(TABLE_DTYPES)})")


def dequantize_table(wire: torch.Tensor,
                     scale: Optional[torch.Tensor]) -> torch.Tensor:
    out = wire.to(torch.float32)
    if scale is not None:
        out = out * scale
    return out


def wire_roundtrip(table: torch.Tensor, dtype: str) -> torch.Tensor:
    """The float32 table the server sees after a `dtype` wire; the same
    tensor object for f32."""
    if dtype == "f32":
        return table
    return dequantize_table(*quantize_table(table, dtype))


def wire_table_bytes(num_rows: int, num_cols: int, dtype: str) -> int:
    """Bytes of one [r, c] table on a `dtype` wire: r * c elements, plus
    int8's r float32 scales."""
    n = num_rows * num_cols * table_elem_bytes(dtype)
    if dtype == "int8":
        n += 4 * num_rows
    return n
