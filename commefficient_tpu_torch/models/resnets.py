"""The torchvision-style ResNet family with pluggable normalization:
the port of commefficient_tpu/models/resnets.py (reference
models/resnets.py, models/resnet101ln.py and the Fixup bottleneck net
FixupResNet50).

Same architectures and the same parameter trees as the flax modules:
the stem is `conv1` / `bn1`, the blocks are attributes named as flax
names them (`BasicBlock_0`, `Bottleneck_0` ... `Bottleneck_15`,
`FixupBottleneck_3`, ...), each block's parameters sit under `conv1`,
`bn1`, ..., `downsample`, `bn_down` (Fixup: `add1a` ... `add3b`,
`mul`), and the head is `fc`. So `jax_layout()` gives the JAX flat
order, in which `Bottleneck_10` sorts before `Bottleneck_2`.

Norms: "batch" (StatelessBatchNorm), "layer" (normalizes each image
over (H, W, C) with a scale and a bias of shape [H, W, C], as flax's
LayerNorm over the last three axes does; kept [C, H, W] here, so the
net is built for one input size, `input_hw`), "group" (32 groups) and
"none". Both flax norms take epsilon 1e-6.

The public input is NHWC, as the JAX models take it; the body runs
NCHW. Padding: 3 for the 7x7 stem, 1 for every 3x3, none for a 1x1
(flax's SAME pads a 1x1 convolution by nothing at any stride), and
the stem's 3x3/2 max pool pads with -inf, as flax's does.
"""
from __future__ import annotations

import inspect
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from commefficient_tpu_torch.models.fixup_resnet import (
    ScalarAdd, ScalarMul, _fixup_branch_normal,
)
from commefficient_tpu_torch.models.resnet9 import (
    StatelessBatchNorm, _truncated_normal, conv_net_layout,
    load_flat_shaped as _load,
)
from commefficient_tpu_torch.ops.flat import LayoutEntry

FLAX_NORM_EPSILON = 1e-6
NORMS = ("batch", "layer", "group", "none")
BLOCKS = ("basic", "bottleneck", "fixup_bottleneck")


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


class LayerNorm(nn.Module):
    """flax `LayerNorm(reduction_axes=(-3, -2, -1), feature_axes=(-3,
    -2, -1))` on NCHW: each image normalized over all its (C, H, W)
    values, then a per-position scale and bias ([C, H, W] here, [H, W,
    C] in the flat vector)."""

    # conv_net_layout: torch's [C, H, W] holds flax's axes 2, 0, 1
    FLAX_TO_TORCH = (2, 0, 1)

    def __init__(self, channels: int, hw: Tuple[int, int]):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels, *hw))
        self.bias = nn.Parameter(torch.zeros(channels, *hw))

    def forward(self, x):
        # in float32 for a bfloat16 input, rounded once at the end (flax
        # reduces and normalizes in float32)
        xf = _at_least_f32(x)
        mean = xf.mean(dim=(1, 2, 3), keepdim=True)
        var = xf.var(dim=(1, 2, 3), unbiased=False, keepdim=True)
        return ((xf - mean) * torch.rsqrt(var + FLAX_NORM_EPSILON)
                * _at_least_f32(self.scale)
                + _at_least_f32(self.bias)).to(x.dtype)


class GroupNorm(nn.Module):
    """flax `GroupNorm(num_groups=32)`: its parameters are `scale` and
    `bias` [C]."""

    def __init__(self, channels: int, num_groups: int = 32):
        super().__init__()
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        # in float32 for a bfloat16 input, as LayerNorm above
        return F.group_norm(_at_least_f32(x), self.num_groups,
                            _at_least_f32(self.scale),
                            _at_least_f32(self.bias),
                            FLAX_NORM_EPSILON).to(x.dtype)


def _norm(kind: str, channels: int, hw: Tuple[int, int]
          ) -> Optional[nn.Module]:
    if kind == "batch":
        return StatelessBatchNorm(channels)
    if kind == "layer":
        return LayerNorm(channels, hw)
    if kind == "group":
        return GroupNorm(channels)
    if kind == "none":
        return None
    raise ValueError(f"unknown norm {kind}")


def _half(hw: Tuple[int, int], stride: int) -> Tuple[int, int]:
    """Spatial size after a stride-`stride` convolution (or the stem's
    pool) that pads to keep ceil(size / stride)."""
    return tuple(-(-s // stride) for s in hw)


class _Block(nn.Module):
    """Shared by the three block kinds: the norm slots (absent when the
    norm is "none") and the shortcut."""

    def _add_norm(self, name: str, kind: str, channels: int, hw) -> None:
        m = _norm(kind, channels, hw)
        if m is not None:
            setattr(self, name, m)

    def _n(self, name: str, x):
        return getattr(self, name)(x) if hasattr(self, name) else x

    def _shortcut(self, x):
        if not hasattr(self, "downsample"):
            return x
        return self._n("bn_down", self.downsample(x))


class BasicBlock(_Block):
    """(JAX resnets.BasicBlock) conv3x3/stride -> norm -> relu ->
    conv3x3 -> norm, plus the shortcut (1x1/stride conv + norm when the
    shape changes)."""
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int, norm: str,
                 hw: Tuple[int, int]):
        super().__init__()
        out_hw = _half(hw, stride)
        self.conv1 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self._add_norm("bn1", norm, features, out_hw)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self._add_norm("bn2", norm, features, out_hw)
        if stride != 1 or cin != features:
            self.downsample = nn.Conv2d(cin, features, 1, stride, bias=False)
            self._add_norm("bn_down", norm, features, out_hw)

    def forward(self, x):
        y = F.relu(self._n("bn1", self.conv1(x)))
        y = self._n("bn2", self.conv2(y))
        return F.relu(y + self._shortcut(x))


class Bottleneck(_Block):
    """(JAX resnets.Bottleneck) 1x1 -> norm -> relu -> 3x3/stride ->
    norm -> relu -> 1x1 (4x wide) -> norm, plus the shortcut."""
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, norm: str,
                 hw: Tuple[int, int]):
        super().__init__()
        out_ch, out_hw = 4 * features, _half(hw, stride)
        self.conv1 = nn.Conv2d(cin, features, 1, bias=False)
        self._add_norm("bn1", norm, features, hw)
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self._add_norm("bn2", norm, features, out_hw)
        self.conv3 = nn.Conv2d(features, out_ch, 1, bias=False)
        self._add_norm("bn3", norm, out_ch, out_hw)
        if stride != 1 or cin != out_ch:
            self.downsample = nn.Conv2d(cin, out_ch, 1, stride, bias=False)
            self._add_norm("bn_down", norm, out_ch, out_hw)

    def forward(self, x):
        y = F.relu(self._n("bn1", self.conv1(x)))
        y = F.relu(self._n("bn2", self.conv2(y)))
        y = self._n("bn3", self.conv3(y))
        return F.relu(y + self._shortcut(x))


class FixupBottleneck(_Block):
    """(JAX resnets.FixupBottleneck) the bottleneck without norms: a
    scalar bias before and after each conv, a scalar scale on the
    branch, and a bare 1x1/stride conv as the shortcut."""
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int, norm: str,
                 hw: Tuple[int, int]):
        super().__init__()
        out_ch = 4 * features
        self.add1a, self.add1b = ScalarAdd(), ScalarAdd()
        self.add2a, self.add2b = ScalarAdd(), ScalarAdd()
        self.add3a, self.add3b = ScalarAdd(), ScalarAdd()
        self.mul = ScalarMul()
        self.conv1 = nn.Conv2d(cin, features, 1, bias=False)
        self.conv2 = nn.Conv2d(features, features, 3, stride, 1, bias=False)
        self.conv3 = nn.Conv2d(features, out_ch, 1, bias=False)
        if stride != 1 or cin != out_ch:
            self.downsample = nn.Conv2d(cin, out_ch, 1, stride, bias=False)

    def forward(self, x):
        y = F.relu(self.add1b(self.conv1(self.add1a(x))))
        y = F.relu(self.add2b(self.conv2(self.add2a(y))))
        y = self.add3b(self.mul(self.conv3(self.add3a(y))))
        return F.relu(y + self._shortcut(x))


_BLOCK_CLASSES = {"basic": BasicBlock, "bottleneck": Bottleneck,
                  "fixup_bottleneck": FixupBottleneck}


class ResNet(nn.Module):
    """(JAX resnets.ResNet) the ImageNet-stem ResNet: conv1 (7x7/2, or
    3x3/1 with `small_input`) -> bn1 (not on the Fixup net) -> relu ->
    3x3/2 max pool (not with `small_input`) -> the stages' blocks
    (stride 2 at the first block of stages 2-4, stage widths `width` x
    1, 2, 4, 8) -> global mean pool -> fc. `input_hw` is the input's
    spatial size: only the LayerNorm parameters depend on it."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 block: str = "bottleneck", norm: str = "batch",
                 width: int = 64, initial_channels: int = 3,
                 small_input: bool = False,
                 input_hw: Tuple[int, int] = (224, 224), seed: int = 0):
        super().__init__()
        if block not in BLOCKS or norm not in NORMS:
            raise ValueError(f"unknown block {block!r} or norm {norm!r}")
        self.block = block
        self.num_layers = sum(stage_sizes)
        self.small_input = small_input
        hw = tuple(input_hw)
        if small_input:
            self.conv1 = nn.Conv2d(initial_channels, 64, 3, 1, 1, bias=False)
        else:
            self.conv1 = nn.Conv2d(initial_channels, 64, 7, 2, 3, bias=False)
            hw = _half(hw, 2)
        if block != "fixup_bottleneck":
            m = _norm(norm, 64, hw)
            if m is not None:
                self.bn1 = m
        if not small_input:
            hw = _half(hw, 2)
        cls = _BLOCK_CLASSES[block]
        self.block_names: List[str] = []
        cin = 64
        for stage, n in enumerate(stage_sizes):
            feats = width * 2 ** stage
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"{cls.__name__}_{len(self.block_names)}"
                setattr(self, name, cls(cin, feats, stride, norm, hw))
                self.block_names.append(name)
                hw = _half(hw, stride)
                cin = feats * cls.expansion
        self.fc = nn.Linear(cin, num_classes)
        self.reset_parameters(seed)

    def forward(self, x):
        """x: [N, H, W, C] images -> [N, num_classes] logits."""
        x = self.conv1(x.permute(0, 3, 1, 2))
        if hasattr(self, "bn1"):
            x = self.bn1(x)
        x = F.relu(x)
        if not self.small_input:
            x = F.max_pool2d(x, 3, 2, 1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return self.fc(x.mean(dim=(2, 3)))

    def jax_layout(self) -> List[LayoutEntry]:
        return conv_net_layout(self)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """numpy `RandomState(seed)` weights with the JAX init formulas:
        lecun_normal (truncated) for every conv and for the head of the
        normed nets; on the Fixup net the Fixup branch normal (L =
        sum(stage_sizes)) for each block's conv1 and conv2, conv3 and
        the head zero, the fan-out normal for each downsample; norm and
        Mul scales 1, every bias 0. Not the JAX package's random numbers
        (tests load those through models/convert.py). A module on the
        meta device holds no values, so nothing is drawn for it."""
        if self.fc.weight.is_meta:
            return
        rng = np.random.RandomState(seed)
        fixup = self.block == "fixup_bottleneck"
        params = dict(self.named_parameters())
        for e in sorted(self.jax_layout(), key=lambda e: e.path):
            p = params[e.name]
            owner, leaf = e.path[-2], e.path[-1]
            in_block = len(e.path) == 3
            if leaf != "kernel":
                p.fill_(1.0 if leaf == "scale" else 0.0)
            elif fixup and in_block and owner in ("conv1", "conv2"):
                _load(p, e, _fixup_branch_normal(rng, e.flat_shape,
                                                 self.num_layers))
            elif fixup and in_block and owner == "downsample":
                _load(p, e, _fixup_branch_normal(rng, e.flat_shape, 1))
            elif fixup and (owner == "fc" or owner == "conv3"):
                p.zero_()
            else:
                fan_in = int(np.prod(e.flat_shape[:-1]))
                _load(p, e, _truncated_normal(rng, e.flat_shape,
                                              np.sqrt(1.0 / fan_in)))


# ---- named constructors (JAX resnets.py:168-196) ----------------------

def _factory(name: str, doc: str, **bound):
    """A ResNet constructor with `bound` fixed. Its signature is
    ResNet's without the bound fields, so the registry's filter of the
    shared model config (models.build_model) sees the fields it takes."""
    def make(**kw):
        return ResNet(**bound, **kw)
    sig = inspect.signature(ResNet)
    make.__signature__ = sig.replace(parameters=[
        p for p in sig.parameters.values() if p.name not in bound])
    make.__name__ = make.__qualname__ = name
    make.__doc__ = doc
    return make


resnet18 = _factory("resnet18", "ResNet18 (basic blocks, 2-2-2-2).",
                    stage_sizes=(2, 2, 2, 2), block="basic")
resnet34 = _factory("resnet34", "ResNet34 (basic blocks, 3-4-6-3).",
                    stage_sizes=(3, 4, 6, 3), block="basic")
resnet50 = _factory("resnet50", "ResNet50 (bottlenecks, 3-4-6-3).",
                    stage_sizes=(3, 4, 6, 3), block="bottleneck")
resnet101 = _factory("resnet101", "ResNet101 (bottlenecks, 3-4-23-3).",
                     stage_sizes=(3, 4, 23, 3), block="bottleneck")
resnet152 = _factory("resnet152", "ResNet152 (bottlenecks, 3-8-36-3).",
                     stage_sizes=(3, 8, 36, 3), block="bottleneck")
wide_resnet50_2 = _factory(
    "wide_resnet50_2", "ResNet50 at base width 128.",
    stage_sizes=(3, 4, 6, 3), block="bottleneck", width=128)
wide_resnet101_2 = _factory(
    "wide_resnet101_2", "ResNet101 at base width 128.",
    stage_sizes=(3, 4, 23, 3), block="bottleneck", width=128)
resnet101ln = _factory(
    "resnet101ln", "ResNet101 with LayerNorm (reference "
    "models/resnet101ln.py:8-13).",
    stage_sizes=(3, 4, 23, 3), block="bottleneck", norm="layer")
fixup_resnet50 = _factory(
    "fixup_resnet50", "FixupResNet50: Fixup bottlenecks, no norms.",
    stage_sizes=(3, 4, 6, 3), block="fixup_bottleneck")
