"""ResNet9 (cifar10-fast style): the port of
commefficient_tpu/models/resnet9.py.

Same architecture and the same parameter tree: prep / layer1 +
residual / layer2 / layer3 + residual conv stack of 3x3 bias-free
convolutions, optional StatelessBatchNorm, global max pool, bias-free
head, 0.125 logit scale. Submodules carry the flax names (ConvBlock_0,
Residual_1, Conv_0, head, ...) so `jax_layout()` can state where each
parameter sits in the JAX package's flat vector (ops/flat.py).

The public input stays NHWC, as the JAX model takes it; the body runs
NCHW, PyTorch's convolution layout.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from commefficient_tpu_torch.ops import lowp
from commefficient_tpu_torch.ops.flat import LayoutEntry

DEFAULT_CHANNELS = {"prep": 64, "layer1": 128, "layer2": 256, "layer3": 512}

# flax HWIO conv kernel -> torch OIHW weight; flax [in, out] dense
# kernel -> torch [out, in] weight
_HWIO_TO_OIHW = (3, 2, 0, 1)
_IO_TO_OI = (1, 0)


class StatelessBatchNorm(nn.Module):
    """Batch normalization from the current batch's statistics only:
    learnable scale/bias, no running averages (the JAX module's
    reasoning: federated clients never share BN buffers)."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        # jnp's mean and var: float32 from the upcast batch, rounded
        # once, for a bfloat16 input (ops/lowp.py)
        mean = lowp.mean(x, dim=(0, 2, 3), keepdim=True)
        var = lowp.var(x, dim=(0, 2, 3), keepdim=True)
        return ((x - mean) * torch.rsqrt(var + self.epsilon)
                * self.scale[None, :, None, None]
                + self.bias[None, :, None, None])


class ConvBlock(nn.Module):
    """conv3x3 (no bias) -> [BN] -> ReLU -> [2x2 max pool]."""

    def __init__(self, cin: int, cout: int, do_batchnorm: bool = False,
                 pool: bool = False):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, 3, stride=1, padding=1,
                                bias=False)
        self.do_batchnorm = do_batchnorm
        if do_batchnorm:
            self.StatelessBatchNorm_0 = StatelessBatchNorm(cout)
        self.pool = pool

    def forward(self, x):
        x = self.Conv_0(x)
        if self.do_batchnorm:
            x = self.StatelessBatchNorm_0(x)
        x = F.relu(x)
        if self.pool:
            x = F.max_pool2d(x, 2, 2)
        return x


class Residual(nn.Module):
    """x + two conv blocks."""

    def __init__(self, ch: int, do_batchnorm: bool = False):
        super().__init__()
        self.ConvBlock_0 = ConvBlock(ch, ch, do_batchnorm)
        self.ConvBlock_1 = ConvBlock(ch, ch, do_batchnorm)

    def forward(self, x):
        return x + self.ConvBlock_1(self.ConvBlock_0(x))


class ResNet9(nn.Module):
    def __init__(self, num_classes: int = 10,
                 channels: Optional[Dict[str, int]] = None,
                 weight: float = 0.125, do_batchnorm: bool = False,
                 initial_channels: int = 3, seed: int = 0):
        super().__init__()
        ch = channels or DEFAULT_CHANNELS
        bn = do_batchnorm
        self.ConvBlock_0 = ConvBlock(initial_channels, ch["prep"], bn)
        self.ConvBlock_1 = ConvBlock(ch["prep"], ch["layer1"], bn, pool=True)
        self.Residual_0 = Residual(ch["layer1"], bn)
        self.ConvBlock_2 = ConvBlock(ch["layer1"], ch["layer2"], bn,
                                     pool=True)
        self.ConvBlock_3 = ConvBlock(ch["layer2"], ch["layer3"], bn,
                                     pool=True)
        self.Residual_1 = Residual(ch["layer3"], bn)
        self.head = nn.Linear(ch["layer3"], num_classes, bias=False)
        self.weight = weight
        self.reset_parameters(seed)

    def forward(self, x):
        """x: [N, H, W, C] images -> [N, num_classes] logits."""
        x = x.permute(0, 3, 1, 2)
        x = self.ConvBlock_0(x)
        x = self.ConvBlock_1(x)
        x = self.Residual_0(x)
        x = self.ConvBlock_2(x)
        x = self.ConvBlock_3(x)
        x = self.Residual_1(x)
        x = x.amax(dim=(2, 3))
        return self.head(x) * self.weight

    def jax_layout(self) -> List[LayoutEntry]:
        return conv_net_layout(self)

    @torch.no_grad()
    def reset_parameters(self, seed: int = 0) -> None:
        """Random weights from numpy `RandomState(seed)`, with flax's
        initializers: he_normal (truncated) for the convs, lecun_normal
        (truncated) for the head, ones/zeros for BN scale/bias. Not the
        JAX package's random numbers (tests load those through
        models/convert.py)."""
        rng = np.random.RandomState(seed)
        for e in sorted(self.jax_layout(), key=lambda e: e.path):
            p = dict(self.named_parameters())[e.name]
            if e.path[-1] == "kernel":
                fan_in = int(np.prod(e.flat_shape[:-1]))
                gain = 2.0 if len(e.flat_shape) == 4 else 1.0
                load_flat_shaped(p, e, _truncated_normal(
                    rng, e.flat_shape, np.sqrt(gain / fan_in)))
            elif e.path[-1] == "scale":
                p.fill_(1.0)
            else:
                p.zero_()


def conv_net_layout(module: nn.Module) -> List[LayoutEntry]:
    """Where each parameter of a convolutional net whose submodules
    carry the flax names sits in the JAX package's flat vector: its
    flax path and flax shape (conv kernels HWIO, dense kernels
    [in, out]; every other parameter as it is, or permuted as its
    module's `FLAX_TO_TORCH` says: for each torch axis, the flax axis
    it holds)."""
    out = []
    for mname, mod in module.named_modules():
        perm = getattr(mod, "FLAX_TO_TORCH", None)
        for pname, p in mod.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            out.append(_conv_net_entry(name, p, perm))
    return out


def _conv_net_entry(name: str, p: torch.Tensor, perm) -> LayoutEntry:
    parts = name.split(".")
    if perm is not None:
        flat_shape = [0] * p.dim()
        for t, f in enumerate(perm):
            flat_shape[f] = p.shape[t]
        return LayoutEntry(tuple(parts), name, tuple(flat_shape),
                           tuple(perm))
    if parts[-1] == "weight" and p.dim() == 4:
        o, i, h, w = p.shape
        return LayoutEntry(tuple(parts[:-1]) + ("kernel",), name,
                           (h, w, i, o), _HWIO_TO_OIHW)
    if parts[-1] == "weight" and p.dim() == 2:
        o, i = p.shape
        return LayoutEntry(tuple(parts[:-1]) + ("kernel",), name, (i, o),
                           _IO_TO_OI)
    return LayoutEntry(tuple(parts), name, tuple(p.shape))


def load_flat_shaped(p: torch.Tensor, e: LayoutEntry,
                     flat: np.ndarray) -> None:
    """Copy a numpy array in the parameter's flat (flax) shape into the
    torch parameter, permuted to its torch shape."""
    t = torch.from_numpy(flat)
    if e.to_torch is not None:
        t = t.permute(*e.to_torch)
    p.copy_(t)


def _truncated_normal(rng: np.random.RandomState, shape, std: float):
    """Normal at +-2 sigma, rescaled to `std` as flax's
    variance_scaling(truncated_normal) does."""
    z = rng.standard_normal(shape)
    bad = np.abs(z) > 2.0
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(z) > 2.0
    return (z * (std / 0.87962566103423978)).astype(np.float32)
