"""Device selection for the port's entry points.

Every entry point takes a `device` argument that defaults to "cuda"
and raises when no GPU is present: a run that asked for the card never
falls back to the CPU silently. Tests pass `device="cpu"` explicitly.

TF32 is switched off for both matmuls and cuDNN convolutions: the JAX
reference computes in full float32, and TF32 keeps only about three
decimal digits, which would put the card's gradients and sketch
tables outside the parity tolerances. cuBLAS's bfloat16 GEMMs (--bf16)
may not reduce in bfloat16 either: they accumulate in float32 and
round once, as XLA's bfloat16 dots do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The torch.device for `device`, with the card's float32 matmul
    and convolution precision pinned to full float32 (module
    docstring). Raises RuntimeError for a CUDA device when no GPU is
    available."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain versions on "
                "the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
