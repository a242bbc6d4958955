"""Model registry of the port: every `--model` name of the JAX
package's registry (commefficient_tpu/models/__init__.py), and GPT2
through `build_gpt2` (exported as the JAX package exports it; the GPT2
driver builds it, never `--model`). `ResNet18` is the PreAct net of
fixup_resnet.py, as in JAX; resnets.resnet18 stays unregistered."""
from __future__ import annotations

import inspect
from typing import Callable, Dict

from commefficient_tpu_torch.models.resnet9 import (  # noqa: F401
    ResNet9, StatelessBatchNorm,
)
from commefficient_tpu_torch.models.fixup_resnet import (  # noqa: F401
    FixupResNet9, FixupResNet18, ResNet18,
)
from commefficient_tpu_torch.models import resnets
from commefficient_tpu_torch.models.resnets import ResNet  # noqa: F401
from commefficient_tpu_torch.models.gpt2 import (  # noqa: F401
    GPT2Config, GPT2DoubleHeads, build_gpt2,
)

_REGISTRY: Dict[str, Callable] = {
    "ResNet9": ResNet9,
    "FixupResNet9": FixupResNet9,
    "ResNet18": ResNet18,
    "FixupResNet18": FixupResNet18,
    "ResNet34": resnets.resnet34,
    "ResNet50": resnets.resnet50,
    "ResNet101": resnets.resnet101,
    "ResNet152": resnets.resnet152,
    "WideResNet50_2": resnets.wide_resnet50_2,
    "WideResNet101_2": resnets.wide_resnet101_2,
    "ResNet101LN": resnets.resnet101ln,
    "FixupResNet50": resnets.fixup_resnet50,
}


def model_names():
    return sorted(_REGISTRY)


def build_model(name: str, **config):
    """Instantiate a model by flag name, dropping config keys it does
    not take (one shared model_config dict serves every model; the
    resnets factories state their fields in their signatures)."""
    try:
        cls = _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; known: "
                         f"{model_names()}") from None
    fields = set(inspect.signature(cls).parameters)
    return cls(**{k: v for k, v in config.items() if k in fields})
