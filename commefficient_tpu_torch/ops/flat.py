"""Flat-parameter-vector substrate: the port of
commefficient_tpu/ops/flat.py.

The round works on one flat float32 vector of all trainable
parameters. The port's vector keeps the JAX package's layout — the
order of `jax.flatten_util.ravel_pytree` over the flax parameter tree
(sorted keys at every level, each leaf raveled in its flax shape, e.g.
a conv kernel as HWIO) — because sketch buckets are a function of the
coordinate index: any other layout would make the tables of the two
packages incomparable. `nn.Module.parameters()` order is NOT this
order, so a model declares its layout (`jax_layout()`); a module that
does not is flattened in sorted parameter-name order with its torch
shapes.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from commefficient_tpu_torch.ops.prng import normal

TOPK_THRESHOLD_MIN_D = 4 * 1024 * 1024
_TOPK_SAMPLE = 1024 * 1024


class LayoutEntry(NamedTuple):
    """One parameter in the flat vector: its flax key path, its torch
    name (for `torch.func.functional_call`), its shape in the flat
    vector (the flax shape) and the permutation from that shape to the
    torch shape (None when the two agree)."""
    path: Tuple[str, ...]
    name: str
    flat_shape: Tuple[int, ...]
    to_torch: Optional[Tuple[int, ...]] = None

    @property
    def size(self) -> int:
        n = 1
        for s in self.flat_shape:
            n *= s
        return n

    @property
    def to_flat(self) -> Optional[Tuple[int, ...]]:
        if self.to_torch is None:
            return None
        inv = [0] * len(self.to_torch)
        for i, p in enumerate(self.to_torch):
            inv[p] = i
        return tuple(inv)


def module_layout(module: torch.nn.Module) -> List[LayoutEntry]:
    """The module's flat layout, in ravel_pytree order (sorted paths)."""
    if hasattr(module, "jax_layout"):
        entries = list(module.jax_layout())
    else:
        entries = [LayoutEntry(tuple(n.split(".")), n, tuple(p.shape))
                   for n, p in module.named_parameters()]
    return sorted(entries, key=lambda e: e.path)


def flatten_tensors(layout: List[LayoutEntry],
                    params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Torch-shaped parameters -> the flat float32 vector."""
    segs = []
    for e in layout:
        t = params[e.name]
        if e.to_flat is not None:
            t = t.permute(*e.to_flat)
        segs.append(t.reshape(-1).to(torch.float32))
    return torch.cat(segs)


def unflatten(layout: List[LayoutEntry],
              vec: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The flat vector -> {torch name: torch-shaped view}. One
    `torch.split`, so the backward writes the gradient of every view
    into one [D] buffer (per-view slicing would materialize a [D]
    gradient per parameter)."""
    sizes = [e.size for e in layout]
    if sum(sizes) != vec.shape[0]:
        raise ValueError(f"flat vector has {vec.shape[0]} entries, the "
                         f"layout {sum(sizes)}")
    out = {}
    for e, seg in zip(layout, torch.split(vec, sizes)):
        seg = seg.view(e.flat_shape)
        if e.to_torch is not None:
            seg = seg.permute(*e.to_torch)
        out[e.name] = seg
    return out


def flatten_params(module: torch.nn.Module
                   ) -> Tuple[torch.Tensor, Callable]:
    """(vec, unravel): the module's parameters as one float32 vector in
    the JAX layout, and the map back to {name: tensor} for
    `torch.func.functional_call`."""
    layout = module_layout(module)
    params = dict(module.named_parameters())
    vec = flatten_tensors(layout, {k: v.detach() for k, v in params.items()})

    def unravel(v: torch.Tensor) -> Dict[str, torch.Tensor]:
        return unflatten(layout, v)

    unravel.layout = layout
    return vec, unravel


def topk_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of a 1-D tensor, largest first,
    equal values in ascending index order — `jax.lax.top_k`'s documented
    order, which the JAX package's exact (CPU) top-k follows.
    `torch.topk` leaves the order of ties unspecified, and count-sketch
    estimates tie often (an odd-r median estimate IS one table cell, and
    many coordinates read the same cell), so a stable sort decides
    which of several equal candidates is sent, and in which order the
    re-sketch adds them."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def masked_topk(vec: torch.Tensor, k: int) -> torch.Tensor:
    """`vec` at its ~k largest-magnitude entries, zero elsewhere, per
    row for 2-D input. Exact top-k up to TOPK_THRESHOLD_MIN_D, the
    sampled-threshold selection above it (the JAX gate)."""
    if vec.dim() == 1:
        return _topk_1d(vec, k)
    if vec.dim() == 2:
        return torch.stack([_topk_1d(v, k) for v in vec])
    raise ValueError(f"masked_topk supports 1-D/2-D input, got "
                     f"{vec.dim()}-D")


def _topk_1d(v: torch.Tensor, k: int) -> torch.Tensor:
    if v.shape[0] > TOPK_THRESHOLD_MIN_D:
        return sampled_threshold_mask(v, k)
    idx = topk_indices(v * v, min(k, v.shape[0]))
    mask = torch.zeros_like(v)
    mask[idx] = 1.0
    return v * mask


def threshold_from_sq_sample(sq_sample: torch.Tensor, k: int,
                             total: int) -> torch.Tensor:
    """The k-th-largest-square threshold from a sample of squared
    magnitudes of a `total`-long vector, floored at f32 tiny."""
    n = sq_sample.shape[0]
    ks = max(1, min(int(round(k * n / total)), n))
    vals, _ = torch.topk(sq_sample, ks)
    return torch.clamp(vals[-1], min=torch.finfo(torch.float32).tiny)


def sampled_threshold_mask(v: torch.Tensor, k: int) -> torch.Tensor:
    """Keep every coordinate whose square is at or above the k-th
    largest square estimated from a ~1M strided sample."""
    d = v.shape[0]
    k = min(k, d)
    sq = v * v
    stride = max(1, d // _TOPK_SAMPLE)
    thr = threshold_from_sq_sample(sq[::stride], k, d)
    return torch.where(sq >= thr, v, torch.zeros_like(v))


def clip_to_l2(vec: torch.Tensor, clip: float) -> torch.Tensor:
    """`vec` scaled down to L2 norm `clip` when its norm exceeds it
    (branch-free, as the JAX package's `clip_to_l2`)."""
    norm = torch.linalg.vector_norm(vec)
    scale = torch.where(norm > clip, clip / torch.clamp(norm, min=1e-30),
                        torch.ones_like(norm))
    return vec * scale


def clip_table_to_l2(table: torch.Tensor, l2_est: torch.Tensor,
                     clip: float) -> torch.Tensor:
    """A sketch table scaled by an outside L2 estimate of its vector
    (`CSVec.l2estimate`), down to `clip`."""
    scale = torch.where(l2_est > clip, clip / torch.clamp(l2_est, min=1e-30),
                        torch.ones_like(l2_est))
    return table * scale


def global_norm_clip(vec: torch.Tensor, max_norm: float) -> torch.Tensor:
    """`torch.nn.utils.clip_grad_norm_`'s rule on the flat vector:
    times max_norm / (norm + 1e-6) when the norm exceeds max_norm."""
    norm = torch.linalg.vector_norm(vec)
    scale = torch.where(norm > max_norm, max_norm / (norm + 1e-6),
                        torch.ones_like(norm))
    return vec * scale


def dp_noise(key: torch.Tensor, shape, noise_multiplier: float,
             scale: float = 1.0, device=None) -> torch.Tensor:
    """Gaussian DP noise N(0, 1) * (noise_multiplier * scale) on
    `device`, drawn as `jax.random.normal(key, shape)` draws it
    (ops/prng.py): scale is sqrt(num_workers) at the worker and 1 at
    the server."""
    return normal(key, shape, device) * (noise_multiplier * scale)
