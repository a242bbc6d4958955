"""Tensor parallelism over the layout's `model` group: the port of
commefficient_tpu/parallel/tp.py.

The JAX package states the Megatron-style layout as sharding
constraints and leaves the all-reduces to GSPMD. Here the same layout
is explicit (the standard two-matmul sandwich a block):

  * column-parallel first products: the QKV projection and the MLP
    up-projection. Rank m of the group computes heads
    [m H/mp, (m+1) H/mp) and hidden units [m 4E/mp, (m+1) 4E/mp); its
    input passes `copy_to_model` (the identity forward, an all-reduce
    of the input gradient in the backward);
  * row-parallel second products: the attention and MLP output
    projections over the rank's slice, summed by `reduce_from_model`
    (an all-reduce forward, the identity backward), their biases added
    once after the sum;
  * the tied token embedding sharded over the vocabulary: each rank
    looks up the tokens of its contiguous vocabulary range (zero
    elsewhere) and the lookups are summed; the LM logits of its range
    are computed locally and gathered in vocabulary order before the
    loss (`gather_from_model`, whose backward takes the rank's slice of
    the replicated gradient). The JAX package leaves the logits to
    GSPMD; the port gathers them, so the workload's loss is unchanged.

The flat [D] vector stays replicated on every rank of the group, as
the JAX package's does (parameters are rebuilt from it each step). A
rank's backward then holds the whole gradient of the replicated leaves
but only its own slice of the sharded ones (zeros elsewhere). The
reduce that completes it (`complete_grad_unravel`) sums over the group
the sharded leaves' coordinates of every rank and the replicated
leaves' coordinates of rank 0 alone, so nothing is doubled and every
value is exactly one rank's (x + 0 = x).

Usage: wrap the workload's loss with `tp_loss(loss_fn, layout, rules)`;
FedModel then shards the module (`shard_module`: the submodules that
declare `supports_tensor_parallel` take their slices of the layout's
group) and completes the gradient over the rules' leaves. A layout
without a model axis returns the loss unchanged.
"""
from __future__ import annotations

import re
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from commefficient_tpu_torch.parallel.mesh import MODEL_AXIS

# (path regex, spec) over the flat layout's "/"-joined flax paths, the
# JAX package's rules unchanged: first match wins, unmatched leaves
# replicate. A spec names the dimension (of the flax shape) the model
# axis splits.
GPT2_TP_RULES: Sequence[Tuple[str, tuple]] = (
    (r"attn/c_attn/kernel$", (None, MODEL_AXIS)),
    (r"attn/c_attn/bias$", (MODEL_AXIS,)),
    (r"attn/c_proj/kernel$", (MODEL_AXIS, None)),
    (r"mlp/c_fc/kernel$", (None, MODEL_AXIS)),
    (r"mlp/c_fc/bias$", (MODEL_AXIS,)),
    (r"mlp/c_proj/kernel$", (MODEL_AXIS, None)),
    (r"wte/embedding$", (MODEL_AXIS, None)),
)


def shares(n: int, mp: int) -> list:
    """The contiguous shares [lo, hi) of n units over mp ranks: ceil(n /
    mp) a rank, the last rank taking the rest."""
    per = -(-n // mp)
    return [(min(m * per, n), min(m * per + per, n)) for m in range(mp)]


def split_range(n: int, layout) -> Tuple[int, int]:
    """This rank's share of n units over the model group (shares)."""
    return shares(n, layout.model)[layout.model_index]


def even_range(n: int, layout, what: str) -> Tuple[int, int]:
    """split_range for a count the group must divide (heads, hidden
    units)."""
    if n % layout.model:
        raise ValueError(f"{what}={n} not divisible by "
                         f"model_parallel={layout.model}")
    return split_range(n, layout)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce of the gradient over the model
    group (Megatron's f)."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.all_reduce(g.contiguous().clone(),
                                     MODEL_AXIS), None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce forward over the model group; identity backward
    (Megatron's g)."""

    @staticmethod
    def forward(ctx, x, layout):
        return layout.all_reduce(x.contiguous().clone(), MODEL_AXIS)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """Every rank's slice of the last dimension, concatenated in rank
    order (ranges from split_range of `total`, one broadcast a rank);
    the backward takes this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, layout, total):
        lo, hi = split_range(total, layout)
        ctx.lo, ctx.hi = lo, hi
        return layout.gather(
            x, MODEL_AXIS, dim=-1,
            sizes=[b - a for a, b in shares(total, layout.model)])

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.hi], None, None


def copy_to_model(x: torch.Tensor, layout) -> torch.Tensor:
    return _CopyToModel.apply(x, layout)


def reduce_from_model(x: torch.Tensor, layout) -> torch.Tensor:
    return _ReduceFromModel.apply(x, layout)


def gather_from_model(x: torch.Tensor, layout, total: int) -> torch.Tensor:
    return _GatherFromModel.apply(x, layout, total)


def vocab_embedding(ids: torch.Tensor, weight: torch.Tensor,
                    layout) -> torch.Tensor:
    """F.embedding(ids, weight) with `weight` [V, E] sharded over the
    vocabulary: the rank's range looked up, zero outside it, summed
    over the group (exact: one rank contributes each row)."""
    lo, hi = split_range(weight.shape[0], layout)
    inside = (ids >= lo) & (ids < hi)
    local = torch.clamp(ids - lo, 0, max(hi - lo - 1, 0))
    e = torch.nn.functional.embedding(local, weight[lo:hi])
    e = torch.where(inside[..., None], e, torch.zeros_like(e))
    return reduce_from_model(e, layout)


def vocab_logits(h: torch.Tensor, weight: torch.Tensor,
                 layout) -> torch.Tensor:
    """F.linear(h, weight) with `weight` [V, E] sharded over the
    vocabulary: the rank's logits, gathered in vocabulary order."""
    lo, hi = split_range(weight.shape[0], layout)
    local = torch.nn.functional.linear(copy_to_model(h, layout),
                                       weight[lo:hi])
    return gather_from_model(local, layout, weight.shape[0])


def shard_module(module: torch.nn.Module, layout) -> int:
    """Give every submodule that declares `supports_tensor_parallel`
    the layout (its `_tp`), so its forward takes its slice of the model
    group; returns how many took it. Shards for good: a module is built
    for one layout."""
    n = 0
    for m in module.modules():
        if getattr(m, "supports_tensor_parallel", False):
            m._tp = layout
            n += 1
    return n


def sharded_coordinates(module: torch.nn.Module,
                        rules: Sequence[Tuple[str, tuple]] = GPT2_TP_RULES
                        ) -> np.ndarray:
    """[D] bool over the module's flat vector: True at the coordinates
    of the leaves a rule shards."""
    from commefficient_tpu_torch.ops.flat import module_layout
    compiled = [re.compile(rx) for rx, _ in rules]
    segs = []
    for e in module_layout(module):
        path = "/".join(e.path)
        hit = any(rx.search(path) for rx in compiled)
        segs.append(np.full(e.size, hit, bool))
    return np.concatenate(segs) if segs else np.zeros((0,), bool)


class _CompleteGrad(torch.autograd.Function):
    """Identity forward on the flat vector; the backward completes its
    gradient over the model group (module docstring)."""

    @staticmethod
    def forward(ctx, w, layout, keep):
        ctx.layout, ctx.keep = layout, keep
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        mine = (g.clone() if ctx.keep is None
                else torch.where(ctx.keep, g, torch.zeros_like(g)))
        return ctx.layout.all_reduce(mine, MODEL_AXIS), None, None


def complete_grad_unravel(unravel: Callable, layout,
                          sharded: torch.Tensor) -> Callable:
    """`unravel` behind _CompleteGrad: the gradient reaching the flat
    vector is the whole one on every rank of the model group. `sharded`
    is sharded_coordinates on the vector's device."""
    keep = None if layout.model_index == 0 else sharded

    def unravel_tp(w):
        return unravel(_CompleteGrad.apply(w, layout, keep))
    return unravel_tp


def tp_loss(loss_fn: Callable, layout,
            rules: Sequence[Tuple[str, tuple]] = GPT2_TP_RULES) -> Callable:
    """Wrap a loss_fn(params, batch, mask) with the layout's tensor
    parallel rules. The wrapper computes what loss_fn does; FedModel
    reads its `tp_layout` and `tp_rules` to shard the module and to
    complete the flat gradient. A layout without a model axis (or
    None) returns loss_fn unchanged."""
    if layout is None or MODEL_AXIS not in layout.axis_names:
        return loss_fn

    def wrapped(params, batch, mask):
        return loss_fn(params, batch, mask)

    wrapped.tp_layout = layout
    wrapped.tp_rules = tuple(rules)
    return wrapped
