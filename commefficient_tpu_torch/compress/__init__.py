"""compress/: the port's Compressor plugin registry, one plugin per
Config.mode (sketch, true_topk, local_topk, fedavg, uncompressed,
powersgd, dp_sketch), asserted to cover config.MODES exactly."""
from __future__ import annotations

from typing import Dict

from commefficient_tpu_torch.compress.base import Compressor
from commefficient_tpu_torch.compress.dp_sketch import DpSketchCompressor
from commefficient_tpu_torch.compress.modes import (
    FedavgCompressor, LocalTopkCompressor, SketchCompressor,
    TrueTopkCompressor, UncompressedCompressor,
)
from commefficient_tpu_torch.compress.powersgd import PowerSGDCompressor
from commefficient_tpu_torch.compress.privacy import (
    RdpAccountant, closed_form_epsilon,
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


def registered_modes() -> tuple:
    return tuple(sorted(_REGISTRY))


for _comp in (SketchCompressor(), TrueTopkCompressor(),
              LocalTopkCompressor(), FedavgCompressor(),
              UncompressedCompressor(), PowerSGDCompressor(),
              DpSketchCompressor()):
    register(_comp)
del _comp


def _assert_covers_modes() -> None:
    # every Config.mode has a plugin and every plugin is a mode
    from commefficient_tpu_torch.config import MODES
    if set(_REGISTRY) != set(MODES):
        raise AssertionError(
            f"compressor registry {sorted(_REGISTRY)} != config.MODES "
            f"{sorted(MODES)}")


_assert_covers_modes()

__all__ = ["Compressor", "RdpAccountant", "closed_form_epsilon",
           "get_compressor", "register", "registered_modes"]
