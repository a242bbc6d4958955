"""The weight bridge between the JAX package and the port.

The port's flat vector IS the JAX flat vector (ops/flat.py), so a
flat vector crosses unchanged; a flax parameter tree is raveled here
the way `ravel_pytree` does (sorted keys at every level, each leaf in
C order). Loading into a torch module then applies each parameter's
layout permutation (conv kernels HWIO -> OIHW, the head's dense kernel
transposed).

Works on numpy arrays and nested dicts (flax FrozenDicts and jax
arrays convert through np.asarray), so nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Union

import numpy as np
import torch

from commefficient_tpu_torch.ops.flat import (
    LayoutEntry, flatten_tensors, module_layout, unflatten,
)

PyTree = Mapping[str, object]


def _leaves_sorted(tree: PyTree, prefix=()) -> List[tuple]:
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, Mapping):
            out.extend(_leaves_sorted(val, prefix + (key,)))
        else:
            out.append((prefix + (key,), np.asarray(val, np.float32)))
    return out


def _strip_params(tree: PyTree) -> PyTree:
    if set(tree) == {"params"}:
        return tree["params"]
    return tree


def ravel_jax_params(src: Union[np.ndarray, PyTree]) -> np.ndarray:
    """The JAX flat vector of a flax parameter tree (or a flat vector,
    returned as float32)."""
    if isinstance(src, Mapping):
        leaves = _leaves_sorted(_strip_params(src))
        return np.concatenate([a.reshape(-1) for _, a in leaves])
    return np.asarray(src, np.float32).reshape(-1)


def from_jax_params(module: torch.nn.Module,
                    src: Union[np.ndarray, PyTree]) -> torch.Tensor:
    """Load JAX parameters (flat vector or flax tree) into `module` and
    return the port's flat vector (which equals the JAX one). A tree's
    paths must match the module's layout exactly."""
    layout = module_layout(module)
    if isinstance(src, Mapping):
        got = [p for p, _ in _leaves_sorted(_strip_params(src))]
        want = [e.path for e in layout]
        if got != want:
            raise ValueError(f"parameter tree paths {got} do not match "
                             f"the module layout {want}")
    vec = torch.from_numpy(ravel_jax_params(src).copy())
    total = sum(e.size for e in layout)
    if vec.shape[0] != total:
        raise ValueError(f"{vec.shape[0]} parameters given, the module "
                         f"has {total}")
    load_flat(module, vec)
    return vec


@torch.no_grad()
def load_flat(module: torch.nn.Module, vec: torch.Tensor) -> None:
    """Copy a flat (JAX-layout) vector into the module's parameters."""
    params = dict(module.named_parameters())
    for name, t in unflatten(module_layout(module), vec).items():
        params[name].copy_(t)


def to_jax_params(module: torch.nn.Module) -> Dict[str, object]:
    """The inverse bridge: {'params': nested dict} of float32 numpy
    arrays in flax shapes, the tree the JAX model's init returns."""
    layout: List[LayoutEntry] = module_layout(module)
    vec = flatten_tensors(layout, {k: v.detach().cpu() for k, v in
                                   module.named_parameters()}).numpy()
    tree: Dict[str, object] = {}
    off = 0
    for e in layout:
        node = tree
        for key in e.path[:-1]:
            node = node.setdefault(key, {})
        node[e.path[-1]] = vec[off:off + e.size].reshape(e.flat_shape).copy()
        off += e.size
    return {"params": tree}
