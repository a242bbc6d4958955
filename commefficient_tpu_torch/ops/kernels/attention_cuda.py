"""Causal flash-attention forward K4: the CUDA kernel for Hopper and its
plain PyTorch version.

K4 `flash_fwd` replaces commefficient_tpu/ops/attention.py
`_flash_fwd_kernel` / `_flash_fwd_pallas`. The kernel lives in
../csrc/flash_fwd.cu, whose header gives its design. At the GPT2-small
main path ([16, 12, 299, 64]) it is bound by bytes (59.0 MB: 17.6 us
at 3.35 TB/s); its f32-accurate products run on the TF32 tensor cores
in three passes (mma.sync, 13 us of operations at 495 TFLOP/s), where
the SIMT f32 pipe would take 33 us. Left for later: wgmma.

The kernel reads q, k and v through their strides (unit stride in Dh,
rows 16-byte aligned), so the head views of GPT2's fused QKV
projection reach it without a copy; it writes o head-merged into a
[B, L, H, Dh] buffer, and the wrapper returns that buffer's
`transpose(1, 2)` view, which the model's head merge reshapes without
a copy. lse is [B, H, L].

q, k and v are float32, or bfloat16 under --bf16 (GPT2's config #5
with L = 299): the JAX kernel upcasts each bf16 tile to float32, runs
the same float32 body and writes o in bf16 and lse in float32, and so
does K4's bf16 instantiation (`cct_flash_fwd_bf16`). The wrapper never
upcasts on the host and never falls back to the plain version for a
CUDA tensor.

Routing is by device, per call: a CPU tensor takes the plain version
(`flash_fwd_plain`, the online-softmax fold of ops/attention.py); a
CUDA tensor launches the kernel or raises.

Counts: `LAUNCHES["flash_fwd"]` (float32 operands) and
`LAUNCHES["flash_fwd_bf16"]` (bfloat16) add one each time the wrapper
launches that instantiation, and nowhere else.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from commefficient_tpu_torch.hooks import kernel_region
from commefficient_tpu_torch.ops.attention import _flash_fwd_plain
from commefficient_tpu_torch.ops.kernels import _build

LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_fwd_bf16": 0}

# the head widths the kernel is instantiated for (GPT2's presets all
# use 64)
SUPPORTED_DH = (16, 32, 64)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the kernel's operand types: (C entry point, launch counter)
_ENTRY = {torch.float32: ("cct_flash_fwd", "flash_fwd"),
          torch.bfloat16: ("cct_flash_fwd_bf16", "flash_fwd_bf16")}


def _declare(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    for name, _ in _ENTRY.values():
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i, ctypes.c_float, vp]
        fn.restype = i


# the plain version: (o, lse) of the JAX package's off-TPU forward
# (`_flash_fwd_xla`), key blocks of DEFAULT_BLOCK
flash_fwd_plain = _flash_fwd_plain


def _strides(name: str, t: torch.Tensor) -> Tuple[int, int, int]:
    """(B, H, L) element strides of a [B, H, L, Dh] operand; raises
    unless its Dh stride is 1 and every row is 16-byte aligned (the
    kernel loads 16 bytes a thread)."""
    sb, sh, sl, sd = t.stride()
    per16 = 16 // t.element_size()
    if (sd != 1 or t.data_ptr() % 16 or sb % per16 or sh % per16
            or sl % per16):
        raise ValueError(f"{name} must have unit stride in Dh and 16-byte "
                         f"aligned rows, got strides {t.stride()} at "
                         f"address {t.data_ptr():#x}")
    return sb, sh, sl


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention forward of q, k, v [B, H, L, Dh]: (o [B, H, L,
    Dh] in q's type, lse [B, H, L] in float32, or float64 for float64
    operands). K4 on CUDA tensors (float32 or bfloat16, any strides with
    unit stride in Dh and 16-byte aligned rows; o is the [B, H, L, Dh]
    view of a head-merged [B, L, H, Dh] buffer), `flash_fwd_plain` on
    CPU tensors (float32 or bfloat16, or float64 for a float64
    reference)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != q.dtype or t.dtype not in (torch.float32,
                                                 torch.bfloat16,
                                                 torch.float64):
            raise TypeError(f"{name} must be torch.float32 or bfloat16 "
                            f"(or float64 on the CPU) like q, got "
                            f"{t.dtype}")
        if t.shape != q.shape or t.dim() != 4:
            raise ValueError(f"q, k, v must share one [B, H, L, Dh] shape, "
                             f"got {tuple(q.shape)} and {name} "
                             f"{tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    with kernel_region(_ENTRY.get(q.dtype, ("", "flash_fwd"))[1], dev,
                       (q.shape,), *flash_fwd_cost(q)):
        if dev.type == "cpu":
            return flash_fwd_plain(q, k, v, sm_scale)
        return _flash_fwd_cuda(q, k, v, sm_scale, dev)


def flash_fwd_cost(q: torch.Tensor) -> tuple:
    """(bytes, operations) K4's bound counts (PERF.md section 6): q, k,
    v read and o written once in their type, lse in float32; 4 Dh
    operations a causal (query, key) pair, three times over for float32
    operands (the three-pass TF32 route that keeps f32 accuracy)."""
    B, H, L, dh = q.shape
    pairs = B * H * L * (L + 1) // 2
    passes = 1 if q.dtype == torch.bfloat16 else 3
    return (4 * q.element_size() * q.numel() + 4 * B * H * L,
            passes * 4 * dh * pairs)


def _flash_fwd_cuda(q, k, v, sm_scale: float, dev):
    if q.dtype not in _ENTRY:
        raise TypeError(f"the flash kernel takes torch.float32 or "
                        f"bfloat16, got {q.dtype}")
    B, H, L, dh = q.shape
    if dh not in SUPPORTED_DH:
        raise ValueError(f"flash_fwd supports head widths {SUPPORTED_DH}, "
                         f"got {dh}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the grid's 65535")
    strides = (ctypes.c_longlong * 9)(*_strides("q", q), *_strides("k", k),
                                      *_strides("v", v))
    lib = _build.load("flash_fwd", _declare)
    entry, counter = _ENTRY[q.dtype]
    o = torch.empty((B, L, H, dh), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                   strides, o.data_ptr(), lse.data_ptr(), B,
                                   H, L, dh, float(sm_scale), stream)
    _build.check(lib, code, entry)
    LAUNCHES[counter] += 1
    return o.transpose(1, 2), lse
