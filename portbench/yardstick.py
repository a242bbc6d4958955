"""The benchmark's own arithmetic, frozen: the H100's published peaks,
the model FLOPs of a sketched GPT2 round, and the least time each
kernel region's work could take.

Peaks (NVIDIA's H100 SXM data sheet, dense): 3.35 TB/s of HBM, 67
TFLOP/s of float32 outside the tensor cores and 495 TFLOP/s of TF32 on
them.

A region's bound is the larger of its bytes over the HBM peak and its
operations over the peak of its precision, counting only the work's
own operands, each read once and written once: the vector and the
table for an encode; the table and the estimates or the [d] update it
writes for a decode launch; q, k, v, o and the float32 lse for the
attention forward, whose 4 Dh operations a causal (query, key) pair are
counted once, against TF32's peak (no float32-accurate scheme is
faster). Hash offsets and sign tables an implementation reads are not
counted. So no implementation can read above 100%.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12

# the threshold decode's sample and the blockwise decode's windows, as
# the configuration's sketch defines them
SAMPLE_TARGET = 1024 * 1024
WINDOW_BYTES = 256 * 1024 * 1024


def model_flops_per_token(n_layer: int, n_embd: int, vocab: int,
                          seq_len: int) -> int:
    """Forward and backward FLOPs of a token: 6 x the block matrices'
    weights (12 n_embd^2 a layer), 6 x the tied LM head's, and the
    attention products over the whole (non-causal) sequence. Work
    recomputed under --remat is not counted."""
    return (6 * 12 * n_layer * n_embd ** 2 + 6 * n_embd * vocab
            + 12 * n_layer * n_embd * seq_len)


def sample_columns(d: int, c: int) -> int:
    padded = -(-d // c) * c
    stride = min(max(1, padded // SAMPLE_TARGET), c)
    return c // stride


def window_sizes(d: int, c: int) -> list:
    """Chunks in each of the blockwise decode's windows, in order."""
    B = -(-d // c)
    step = max(1, min(WINDOW_BYTES // (4 * c), 65535))
    return [min(step, B - b0) for b0 in range(0, B, step)]


def region_bound(name: str, shapes: Sequence[Tuple[int, ...]], d: int,
                 c: int, window_chunks: Optional[int] = None
                 ) -> Optional[Tuple[float, str]]:
    """(seconds, 'bytes' or 'ops') of one launch of a kernel region
    that a cell's traffic reaches, or None for any other region."""
    if name == "sketch_encode":
        (dd,), (r, _) = shapes
        nbytes, ops, peak = 4 * dd + 4 * r * c, 2 * r * dd, F32_FLOPS
    elif name in ("sketch_estimate_window", "threshold_sample",
                  "threshold_mask"):
        (r, cc), (_, B) = shapes
        if name == "threshold_sample":
            out = B * sample_columns(d, cc)
        elif name == "sketch_estimate_window":
            out = window_chunks * cc
        else:
            out = d
        nbytes, ops, peak = 4 * r * cc + 4 * out, r * out, F32_FLOPS
    elif name == "flash_fwd":
        (B, H, L, dh), = shapes
        nbytes = 16 * B * H * L * dh + 4 * B * H * L
        ops = 4 * dh * B * H * L * (L + 1) // 2
        peak = TF32_FLOPS
    else:
        return None
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "ops")
