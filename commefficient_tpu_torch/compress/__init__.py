"""compress/: the port's Compressor plugin registry, one plugin per
ported Config.mode (sketch, true_topk, local_topk, fedavg,
uncompressed)."""
from __future__ import annotations

from typing import Dict

from commefficient_tpu_torch.compress.base import Compressor
from commefficient_tpu_torch.compress.modes import (
    FedavgCompressor, LocalTopkCompressor, SketchCompressor,
    TrueTopkCompressor, UncompressedCompressor,
)

_REGISTRY: Dict[str, Compressor] = {}


def register(comp: Compressor) -> Compressor:
    if not comp.name:
        raise ValueError(f"{type(comp).__name__} has an empty name")
    if comp.name in _REGISTRY:
        raise ValueError(f"compressor {comp.name!r} is already registered")
    _REGISTRY[comp.name] = comp
    return comp


def get_compressor(mode: str) -> Compressor:
    try:
        return _REGISTRY[mode]
    except KeyError:
        raise KeyError(f"no compressor registered for mode {mode!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


for _comp in (SketchCompressor(), TrueTopkCompressor(),
              LocalTopkCompressor(), FedavgCompressor(),
              UncompressedCompressor()):
    register(_comp)
del _comp

__all__ = ["Compressor", "get_compressor", "register"]
