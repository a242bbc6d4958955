"""bfloat16 numerics as the JAX package computes them (--bf16).

torch and XLA both round every elementwise bfloat16 operation and both
reduce bfloat16 sums in float32, but the composite ops differ, and the
port follows what the JAX package's jitted round computes:

  * `log_softmax`: `jax.nn.log_softmax` is a chain of bfloat16 ops
    (shift by the stopped max, exp, sum, log, subtract), each rounded,
    except that XLA's fusion feeds the exp to the float32 sum unrounded.
    torch's fused log_softmax computes in float32 and rounds once.
  * `mean` / `var`: `jnp.mean` and `jnp.var` of a bfloat16 array are
    computed in float32 from the upcast array and rounded once, and
    their gradients are taken in float32 too; torch's var backward
    runs in the input's type.

float32 and float64 inputs take torch's own ops, unchanged.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

_FULL = (torch.float32, torch.float64)


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    if x.dtype in _FULL:
        return F.log_softmax(x, dim=dim)
    shifted = x - x.detach().amax(dim=dim, keepdim=True)
    total = torch.exp(shifted.float()).sum(dim=dim, keepdim=True)
    return shifted - torch.log(total.to(x.dtype))


def mean(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    if x.dtype in _FULL:
        return x.mean(dim=dim, keepdim=keepdim)
    return x.float().mean(dim=dim, keepdim=keepdim).to(x.dtype)


def var(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """The population variance (numpy's ddof = 0)."""
    if x.dtype in _FULL:
        return x.var(dim=dim, unbiased=False, keepdim=keepdim)
    xf = x.float()
    centered = xf - xf.mean(dim=dim, keepdim=True)
    return (centered * centered).mean(dim=dim,
                                      keepdim=keepdim).to(x.dtype)
