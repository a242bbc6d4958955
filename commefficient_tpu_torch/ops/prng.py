"""Threefry-2x32 random numbers as `jax.random` draws them: the part of
`jax.random` that the JAX package's `ops/flat.dp_noise` reaches.

A key is a [2] int64 tensor holding two uint32 words, kept on the host:
deriving one (`fold_in`) is scalar work done on Python ints, and only
the draws (`random_bits`, `uniform`, `normal`) run on a device, the
`device` they are given (the key's own by default). The functions
follow JAX's default threefry implementation with
`jax_threefry_partitionable` on:

  * `PRNGKey(seed)`: the words (seed >> 32, seed & 0xFFFFFFFF) of a
    non-negative seed below 2**32;
  * `fold_in(key, data)`: threefry2x32(key, (0, data));
  * `random_bits(key, shape)`: `bits1 ^ bits2` of threefry2x32(key,
    (hi, lo)), the counter the two words of each element's flat index;
  * `uniform(key, shape, lo, hi)`: the top 23 bits as the mantissa of a
    float in [1, 2), minus 1, times (hi - lo), plus lo, at least lo;
  * `normal(key, shape)`: sqrt(2) * erf_inv(u) of a uniform on
    (nextafter(-1, 0), 1).

The bits and the uniforms are integer arithmetic plus one bitcast, and
the uniform's multiply and add are separate float32 operations, so
they equal `jax.random`'s bit for bit on any device where the product
`floats * (maxval - minval)` is exact: for a range of power-of-two
width, as the normal's (width 2). (XLA's CPU contracts the multiply and
add into one FMA, which rounds once where the product is inexact.) `erf_inv` is
XLA's float32 polynomial (the `chlo.erf_inv` expansion JAX lowers to);
its `log1p` and the final products round as this device rounds them,
so the normals agree with JAX's to a few float32 ulps, not bitwise.

A draw's arithmetic is uint32 held in int64 tensors and masked, on the
caller's device, so the card draws its noise on the card. This is
plain PyTorch: it replaces XLA code, not a Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# elements drawn at a time: bounds the int64 temporaries of one draw
_CHUNK = 1 << 24

DeviceLike = Union[str, torch.device]
Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k0: int, k1: int, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under the key words (k0, k1): JAX's `_threefry2x32_lowering`. The
    key words are ints; the counter words are ints or int64 tensors
    holding uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def _words(key: torch.Tensor) -> Tuple[int, int]:
    k0, k1 = (int(w) for w in key.tolist())  # graftlint: disable=GL002 -- keys live on the host
    return k0, k1


def PRNGKey(seed: int) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for 0 <= seed < 2**32, on the host."""
    seed = int(seed)
    if not 0 <= seed <= _MASK:
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return torch.tensor([seed >> 32, seed & _MASK], dtype=torch.int64)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)` for 0 <= data < 2**32: the hash
    of the counter (0, data) under `key`, on the host."""
    data = int(data)
    if not 0 <= data <= _MASK:
        raise ValueError(f"data must be in [0, 2**32), got {data}")
    return torch.tensor(threefry2x32(*_words(key), 0, data),
                        dtype=torch.int64)


def random_bits(key: torch.Tensor, shape: Shape,
                device: Optional[DeviceLike] = None) -> torch.Tensor:
    """`jax.random.bits(key, shape)` (uint32, partitionable threefry)
    drawn on `device` (the key's by default): element i is bits1 ^
    bits2 of the hash of the counter (i >> 32, i & 0xFFFFFFFF).
    Returned as int64 holding the uint32 values."""
    dev = key.device if device is None else torch.device(device)
    k0, k1 = _words(key)
    shape = _shape(shape)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.int64, device=dev)
    for a in range(0, n, _CHUNK):
        idx = torch.arange(a, min(a + _CHUNK, n), dtype=torch.int64,
                           device=dev)
        b1, b2 = threefry2x32(k0, k1, idx >> 32, idx & _MASK)
        out[a:a + idx.shape[0]] = b1 ^ b2
    return out.reshape(shape)


def _f32(x: float, device) -> torch.Tensor:
    """x rounded to float32 as a 0-d tensor on `device`: a fill, so no
    host-to-device copy waits on the card's queue."""
    return torch.full((), x, dtype=torch.float32, device=device)


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0,
            device: Optional[DeviceLike] = None) -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`, bit for
    bit: floats in [1, 2) from the top 23 bits, minus 1, then
    `floats * (maxval - minval) + minval` as two float32 operations
    (never one fused multiply-add), at least minval."""
    bits = random_bits(key, shape, device)
    dev = bits.device
    one_bits = int(np.array(1.0, np.float32).view(np.uint32))
    floats = ((bits >> 9) | one_bits).to(torch.int32).view(torch.float32)
    floats = floats - _f32(1.0, dev)
    lo, hi = _f32(minval, dev), _f32(maxval, dev)
    scaled = floats * (hi - lo)
    return torch.maximum(lo, scaled + lo)


# XLA's float32 erf_inv (Giles' polynomial): degree-8 coefficients for
# w = -log1p(-x * x) below 5 (in w - 2.5) and at or above it (in
# sqrt(w) - 3)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 erf_inv as XLA expands it: w = -log1p(-x * x), a Horner
    polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, times x; +-inf at
    |x| == 1. Each step is its own float32 operation, as in XLA."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT5[0], x.device),
                    _f32(_ERFINV_GE5[0], x.device))
    for c_lt, c_ge in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, _f32(c_lt, x.device), _f32(c_ge, x.device))
        p = c + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)  # graftlint: disable=GL013 -- XLA's exact saturation test at +-1


def normal(key: torch.Tensor, shape: Shape,
           device: Optional[DeviceLike] = None) -> torch.Tensor:
    """`jax.random.normal(key, shape)` (float32): sqrt(2) * erf_inv(u),
    u uniform on (nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0, device)
    return _f32(float(np.float32(np.sqrt(2))), u.device) * erf_inv(u)
