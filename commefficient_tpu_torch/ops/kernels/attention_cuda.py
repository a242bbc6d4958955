"""Causal flash-attention forward K4: the CUDA kernel for Hopper and its
plain PyTorch version.

K4 `flash_fwd` replaces commefficient_tpu/ops/attention.py
`_flash_fwd_kernel` / `_flash_fwd_pallas`. The kernel lives in
../csrc/flash_fwd.cu, whose header says how it is designed for the card
and what bounds it (operations: ~2.1 GFLOP a launch at the GPT2-small
main path, [192, 294, 64]).

Routing is by device, per call: a CPU tensor takes the plain version
(`flash_fwd_plain`, the online-softmax fold of ops/attention.py); a
CUDA tensor launches the kernel or raises.

Counts: `LAUNCHES["flash_fwd"]` adds one each time the wrapper launches
the kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from commefficient_tpu_torch.ops.attention import _flash_fwd_plain
from commefficient_tpu_torch.ops.kernels import _build

LAUNCHES: Dict[str, int] = {"flash_fwd": 0}

# the head widths the kernel is instantiated for (GPT2's presets all
# use 64)
SUPPORTED_DH = (16, 32, 64)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.cct_flash_fwd.argtypes = [vp, vp, vp, vp, vp, i, i, i,
                                  ctypes.c_float, vp]
    lib.cct_flash_fwd.restype = i


# the plain version: (o, lse) of the JAX package's off-TPU forward
# (`_flash_fwd_xla`), key blocks of DEFAULT_BLOCK
flash_fwd_plain = _flash_fwd_plain


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned (the kernel reads float4s)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention forward of q, k, v [B, H, L, Dh]: (o like q, lse
    [B, H, L]). K4 on CUDA tensors (float32), `flash_fwd_plain` on CPU
    tensors (float32, or float64 for a float64 reference)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != q.dtype or t.dtype not in (torch.float32,
                                                 torch.float64):
            raise TypeError(f"{name} must be torch.float32 (or float64 on "
                            f"the CPU) like q, got {t.dtype}")
        if t.shape != q.shape or t.dim() != 4:
            raise ValueError(f"q, k, v must share one [B, H, L, Dh] shape, "
                             f"got {tuple(q.shape)} and {name} "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
    dev = q.device
    if dev.type == "cpu":
        return flash_fwd_plain(q, k, v, sm_scale)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if q.dtype != torch.float32:
        raise TypeError(f"the flash kernel takes torch.float32, got "
                        f"{q.dtype}")
    B, H, L, dh = q.shape
    if dh not in SUPPORTED_DH:
        raise ValueError(f"flash_fwd supports head widths {SUPPORTED_DH}, "
                         f"got {dh}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the grid's 65535")
    lib = _build.load("flash_fwd", _declare)
    qc, kc, vc = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(qc)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.cct_flash_fwd(qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(), B * H, L, dh,
                                 float(sm_scale), stream)
    _build.check(lib, code, "cct_flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse
