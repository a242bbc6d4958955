"""Model registry of the port: ResNet9, ResNet18, FixupResNet18 and
FixupResNet9 by flag name, and GPT2 through `build_gpt2` (exported as
the JAX package exports it; the GPT2 driver builds it, never
`--model`). The models of the JAX package's `resnets.py` are ROADMAP.md
Queue 1 item 8."""
from __future__ import annotations

import inspect
from typing import Callable, Dict

from commefficient_tpu_torch.models.resnet9 import (  # noqa: F401
    ResNet9, StatelessBatchNorm,
)
from commefficient_tpu_torch.models.fixup_resnet import (  # noqa: F401
    FixupResNet9, FixupResNet18, ResNet18,
)
from commefficient_tpu_torch.models.gpt2 import (  # noqa: F401
    GPT2Config, GPT2DoubleHeads, build_gpt2,
)

_REGISTRY: Dict[str, Callable] = {
    "ResNet9": ResNet9,
    "ResNet18": ResNet18,
    "FixupResNet18": FixupResNet18,
    "FixupResNet9": FixupResNet9,
}


def model_names():
    return sorted(_REGISTRY)


def build_model(name: str, **config):
    """Instantiate a model by flag name, dropping config keys it does
    not take (one shared model_config dict serves every model)."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ported: {model_names()}; "
            "ROADMAP.md Queue 1 item 8)") from None
    fields = set(inspect.signature(cls).parameters)
    return cls(**{k: v for k, v in config.items() if k in fields})
