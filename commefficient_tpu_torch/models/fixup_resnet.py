"""Fixup (normalization-free) and PreAct residual nets: the port of
commefficient_tpu/models/fixup_resnet.py (reference
models/fixup_resnet18.py and the Fixup recipe of models/fixup_resnet9.py).

Same architectures and the same parameter trees as the flax modules:
submodules carry the flax names (PreActBlock_3, FixupBlock_0/add1a,
ScalarAdd_12, Conv_5, classifier, ...), so `jax_layout()` states where
each parameter sits in the JAX package's flat vector (ops/flat.py).
Fixup replaces normalization with its init and scalar biases/scales:
  * conv1 of each block: normal(0, sqrt(2 / (c_out k k)) L^-0.5)
  * conv2 of each block and the classifier: zeros
  * a scalar Add before/after each conv, a scalar Mul on the branch.

The public input is NHWC, as the JAX models take it; the body runs
NCHW.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from commefficient_tpu_torch.models.resnet9 import (
    DEFAULT_CHANNELS, StatelessBatchNorm, _truncated_normal, conv_net_layout,
    load_flat_shaped as _load,
)
from commefficient_tpu_torch.ops.flat import LayoutEntry


class ScalarAdd(nn.Module):
    """Learnable scalar bias (reference Add, fixup_resnet18.py:16-22)."""

    def __init__(self):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return x + self.bias


class ScalarMul(nn.Module):
    """Learnable scalar scale (reference Mul, fixup_resnet18.py:8-14)."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))

    def forward(self, x):
        return x * self.scale


def _conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


def _conv1x1(cin: int, cout: int, stride: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 1, stride=stride, bias=False)


def _dual_pool_head(x):
    """Global avg-pool || max-pool concat (reference
    fixup_resnet18.py:125-131)."""
    return torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=-1)


class FixupBlock(nn.Module):
    """(reference FixupBlock, fixup_resnet18.py:24-63)"""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        if stride != 1 or cin != features:
            self.shortcut = _conv1x1(cin, features, stride)
        else:
            self.shortcut = None
        self.add1a, self.add1b = ScalarAdd(), ScalarAdd()
        self.add2a, self.add2b = ScalarAdd(), ScalarAdd()
        self.conv1 = _conv3x3(cin, features, stride)
        self.conv2 = _conv3x3(features, features)
        self.mul = ScalarMul()

    def forward(self, x):
        shortcut = x if self.shortcut is None else self.shortcut(x)
        y = self.conv1(self.add1a(x))
        y = F.relu(self.add1b(y))
        y = self.conv2(self.add2a(y))
        y = self.add2b(self.mul(y))
        return F.relu(y + shortcut)


class PreActBlock(nn.Module):
    """conv->BN->relu twice + shortcut (reference PreActBlock,
    fixup_resnet18.py:138-165; norm after each conv, as the reference
    ships it)."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv3x3(cin, features, stride)
        self.bn1 = StatelessBatchNorm(features)
        self.conv2 = _conv3x3(features, features)
        self.bn2 = StatelessBatchNorm(features)
        if stride != 1 or cin != features:
            self.shortcut = _conv1x1(cin, features, stride)
        else:
            self.shortcut = None

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        shortcut = x if self.shortcut is None else self.shortcut(x)
        return y + shortcut


class _ResNet18Family(nn.Module):
    """prep conv (64 wide) -> relu -> the blocks of four stages (stride
    2 at the first block of stages 2-4) -> avg || max pool ->
    classifier. Blocks are attributes `<Block>_<i>`, the flax names."""

    block: type = PreActBlock

    def __init__(self, num_classes: int, num_blocks: Sequence[int],
                 widths: Sequence[int], initial_channels: int, seed: int):
        super().__init__()
        self.prep = _conv3x3(initial_channels, 64)
        self.block_names = []
        cin = 64
        for stage, (w, n) in enumerate(zip(widths, num_blocks)):
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"{self.block.__name__}_{len(self.block_names)}"
                setattr(self, name, self.block(cin, w, stride))
                self.block_names.append(name)
                cin = w
        self.classifier = nn.Linear(2 * cin, num_classes)
        self.reset_parameters(seed)

    def forward(self, x):
        """x: [N, H, W, C] images -> [N, num_classes] logits."""
        x = F.relu(self.prep(x.permute(0, 3, 1, 2)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.classifier(_dual_pool_head(x))

    def jax_layout(self) -> List[LayoutEntry]:
        return conv_net_layout(self)


class ResNet18(_ResNet18Family):
    """PreAct-style ResNet18 with stateless BN (reference ResNet18,
    fixup_resnet18.py:168-216)."""
    block = PreActBlock

    def __init__(self, num_classes: int = 10,
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 256),
                 initial_channels: int = 3, seed: int = 0):
        super().__init__(num_classes, num_blocks, widths, initial_channels,
                         seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """numpy `RandomState(seed)` weights with flax's defaults:
        lecun_normal (truncated) for every conv and the classifier
        kernel, ones/zeros for BN scale/bias, a zero classifier bias.
        Not the JAX package's random numbers (tests load those through
        models/convert.py)."""
        rng = np.random.RandomState(seed)
        params = dict(self.named_parameters())
        for e in sorted(self.jax_layout(), key=lambda e: e.path):
            p = params[e.name]
            if e.path[-1] == "kernel":
                fan_in = int(np.prod(e.flat_shape[:-1]))
                _load(p, e, _truncated_normal(rng, e.flat_shape,
                                              np.sqrt(1.0 / fan_in)))
            elif e.path[-1] == "scale":
                p.fill_(1.0)
            else:
                p.zero_()


class FixupResNet18(_ResNet18Family):
    """(reference FixupResNet18, fixup_resnet18.py:66-135)"""
    block = FixupBlock

    def __init__(self, num_classes: int = 10,
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 widths: Sequence[int] = (64, 128, 256, 256),
                 initial_channels: int = 3, seed: int = 0):
        self.num_layers = sum(num_blocks)
        super().__init__(num_classes, num_blocks, widths, initial_channels,
                         seed)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """numpy `RandomState(seed)` weights with the JAX init formulas:
        prep and shortcuts fan-out normal, each block's conv1 the Fixup
        branch normal (L^-0.5), conv2 and the classifier zero, scalar
        biases 0 and scales 1."""
        rng = np.random.RandomState(seed)
        params = dict(self.named_parameters())
        for e in sorted(self.jax_layout(), key=lambda e: e.path):
            p = params[e.name]
            if e.path[-2:] == ("conv1", "kernel"):
                _load(p, e, _fixup_branch_normal(rng, e.flat_shape,
                                                 self.num_layers))
            elif e.path[-1] == "kernel" and e.path[-2] in ("prep",
                                                           "shortcut"):
                _load(p, e, _fixup_branch_normal(rng, e.flat_shape, 1))
            elif e.path[-1] == "scale":
                p.fill_(1.0)
            else:   # conv2, the classifier, the scalar biases
                p.zero_()


class FixupResNet9(nn.Module):
    """ResNet9 topology with Fixup scalar bias/scale and no
    normalization (the capability of reference models/fixup_resnet9.py).
    The flax module creates its submodules inline, so they are named by
    kind and order: Conv_0..7, ScalarAdd_0..15, ScalarMul_0..1, head."""

    def __init__(self, num_classes: int = 10, weight: float = 0.125,
                 initial_channels: int = 3, seed: int = 0):
        super().__init__()
        ch = DEFAULT_CHANNELS
        self._counts = {"Conv": 0, "ScalarAdd": 0, "ScalarMul": 0}
        self.plan = []     # (kind, attribute name / pool / residual marks)
        cin = initial_channels
        for feats, pool, residual in ((ch["prep"], False, False),
                                      (ch["layer1"], True, True),
                                      (ch["layer2"], True, False),
                                      (ch["layer3"], True, True)):
            self.plan.append(("block", self._conv_block(cin, feats), pool))
            if residual:
                self.plan.append(("residual", self._residual(feats), None))
            cin = feats
        self.head = nn.Linear(ch["layer3"], num_classes, bias=False)
        self.weight = weight
        self.reset_parameters(seed)

    def _add(self, kind: str, module: nn.Module) -> str:
        name = f"{kind}_{self._counts[kind]}"
        self._counts[kind] += 1
        setattr(self, name, module)
        return name

    def _conv_block(self, cin: int, feats: int):
        return (self._add("ScalarAdd", ScalarAdd()),
                self._add("Conv", _conv3x3(cin, feats)),
                self._add("ScalarAdd", ScalarAdd()))

    def _residual(self, feats: int):
        return (self._add("ScalarAdd", ScalarAdd()),
                self._add("Conv", _conv3x3(feats, feats)),
                self._add("ScalarAdd", ScalarAdd()),
                self._add("ScalarAdd", ScalarAdd()),
                self._add("Conv", _conv3x3(feats, feats)),
                self._add("ScalarMul", ScalarMul()),
                self._add("ScalarAdd", ScalarAdd()))

    def forward(self, x):
        """x: [N, H, W, C] images -> [N, num_classes] logits."""
        m = self.get_submodule
        x = x.permute(0, 3, 1, 2)
        for kind, names, pool in self.plan:
            if kind == "block":
                a, conv, b = names
                x = F.relu(m(b)(m(conv)(m(a)(x))))
                if pool:
                    x = F.max_pool2d(x, 2, 2)
            else:
                a1, conv1, b1, a2, conv2, mul, b2 = names
                y = F.relu(m(b1)(m(conv1)(m(a1)(x))))
                y = m(b2)(m(mul)(m(conv2)(m(a2)(y))))
                x = x + F.relu(y)
        x = F.max_pool2d(x, 4, 4).flatten(1)
        return self.head(x) * self.weight

    def jax_layout(self) -> List[LayoutEntry]:
        return conv_net_layout(self)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """numpy `RandomState(seed)` weights with the JAX init formulas:
        conv blocks fan-out normal, each residual's first conv the Fixup
        branch normal (L = 2), its second conv and the head zero, scalar
        biases 0 and scales 1."""
        rng = np.random.RandomState(seed)
        branch = {names[1] for kind, names, _ in self.plan
                  if kind == "residual"}
        zero = {names[4] for kind, names, _ in self.plan
                if kind == "residual"}
        params = dict(self.named_parameters())
        for e in sorted(self.jax_layout(), key=lambda e: e.path):
            p = params[e.name]
            owner = e.path[0]
            if e.path[-1] == "kernel" and owner.startswith("Conv_") \
                    and owner not in zero:
                _load(p, e, _fixup_branch_normal(
                    rng, e.flat_shape, 2 if owner in branch else 1))
            elif e.path[-1] == "scale":
                p.fill_(1.0)
            else:   # the residuals' second convs, the head, the biases
                p.zero_()


def _fixup_branch_normal(rng: np.random.RandomState, shape, num_layers: int):
    """normal(0, sqrt(2 / (c_out kh kw)) num_layers^-0.5) for an HWIO
    kernel (JAX `_fixup_branch_init`; num_layers = 1 is `_out_fan_init`)."""
    kh, kw, _, c_out = shape
    std = np.sqrt(2.0 / (c_out * kh * kw)) * num_layers ** (-0.5)
    return (rng.standard_normal(shape) * std).astype(np.float32)

