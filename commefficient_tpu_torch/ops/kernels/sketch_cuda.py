"""Count-sketch kernels K1-K3: CUDA kernels for Hopper with their plain
PyTorch versions.

K1 `encode` replaces commefficient_tpu/ops/kernels/sketch_pallas.py
`pallas_encode` (`_encode_kernel`). It is bound by bytes: x read once
from HBM (498 MB at the GPT2-small geometry; with the table and the
sign bits, 0.152 ms at 3.35 TB/s).
A thread owns 4 table positions for all r rows and every resident
thread walks the chunks in the same order, so x streams from HBM once
and its r-fold re-read hits the L2; that re-read is what is left for
later. eps and delta come as packed sign bits (`pack_sign_bits`, built
once per CSVec and device by `CSVec.sign_bits`), so a term is x with
its sign bit flipped, bitwise the plain version's product.

K2 `estimate_all` replaces `pallas_estimate_all` (`_estimate_kernel`,
`_chunk_estimate_rows`, `_masked_est`, `_median_rows`). It takes eps
and delta as K1's packed sign bits and runs K3b's body (a thread per 8
consecutive positions of a chunk) without the select, writing the
[B, c] estimate with its tail zeroed. Its byte bound counts the table
and the estimate once (38.3 MB at the ResNet9 geometry); the r-fold
gather of the table from L2 (140 MB there) is its floor, as for K3b.
`estimate_window` launches the same kernel on a window of chunks
[b0, b0 + nb), the blockwise top-k decode's (ops/sketch.py), with its
own count.

K3 replaces the two kernels of `pallas_threshold_decode`: K3a
`threshold_sample` (`_sample_kernel`) and K3b `threshold_mask`
(`_mask_kernel`). Both take eps and delta as the packed sign bits K1
takes, so a row's value is the table cell with its sign bit flipped,
bitwise the plain versions' float product, and both take K2's median.
K3b is K2's body and a select, streaming its output; its byte bound
is the [d] output write (498 MB at the GPT2-small geometry), but an
exact decode gathers every table row once per chunk from L2 (2.49 GB),
and that is its floor. K3a is a thread per sample position for a run
of chunks, bound by the gathered sectors, one per table cell it reads.
An early-out of K3b (skip the last rows where the first r / 2 + 1
square under the threshold: exact) measured slower on the card and is
not kept. Left for later: the three kernels' gathers from L2.

The kernels live in ../csrc/sketch.cu, whose header says how each is
designed for the card and what bounds it.

Routing is by device, per call: a CPU tensor takes the plain version
(the CPU tests' path); a CUDA tensor launches the kernel or raises.
There is no fallback from the card to the plain version.

Build: ops/kernels/_build.py (nvcc for sm_90a into `build/`, ctypes).

Counts: `LAUNCHES[name]` adds one each time the wrapper launches the
kernel, and nowhere else (chip_smoke.py reads them around the main
path).

Each wrapper runs its launch, or its plain version, inside a
`hooks.kernel_region` named as its count, with the bytes and operations
its bound counts (`*_cost`, PERF.md section 6, chip_smoke.py's kernels
line): the round recorder writes one kernel entry for it on either
device, and the transfer guard leaves the plain version's host reads
alone.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from commefficient_tpu_torch.hooks import kernel_region
from commefficient_tpu_torch.ops.kernels import _build

# kernel name -> launches through its wrapper (plain versions never count)
LAUNCHES: Dict[str, int] = {"sketch_encode": 0, "sketch_estimate_all": 0,
                            "sketch_estimate_window": 0,
                            "threshold_sample": 0, "threshold_mask": 0}

# the largest row count the register sort network is instantiated for
MAX_ROWS = 16

# strided-sample size target of the threshold decode (the JAX package's
# sketch_pallas._SAMPLE_TARGET, the ~1M-point quantile estimator)
_SAMPLE_TARGET = 1024 * 1024


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# the bytes and operations each kernel's bound counts (PERF.md section 6):
# every operand read once, every output written once, the signs as
# packed bits


def bits_bytes(n: int) -> int:
    """Bytes of the int32 words that hold n packed sign bits."""
    return 4 * -(-n // 32)


def _est_ops(r: int) -> int:
    """Operations of one median-of-rows estimate: 2r sign flips, the
    r(r-1)/2 compare-exchanges (2 each), the middle."""
    return 2 * r + r * (r - 1) + 2


def encode_cost(d: int, r: int, c: int, B: int) -> tuple:
    """(bytes, operations) of K1: x, off and the sign bits read, the
    table written; r * d * (2 multiplies + 1 add)."""
    return (4 * d + 4 * r * B + bits_bytes(r * c) + bits_bytes(r * B)
            + 4 * r * c, 3 * r * d)


def estimate_cost(r: int, c: int, nb: int) -> tuple:
    """(bytes, operations) of K2 over nb chunks: the table, the window's
    offsets and the sign bits read, the [nb, c] estimate written."""
    return (4 * r * c + bits_bytes(r * c) + 4 * r * nb + bits_bytes(r * nb)
            + 4 * nb * c, nb * c * _est_ops(r))


def sample_cost(r: int, c: int, B: int, ns: int) -> tuple:
    """(bytes, operations) of K3a: the table, the sampled eps bits, off
    and the delta bits read, the [B, ns] sample written."""
    return (4 * r * c + bits_bytes(r * ns) + 4 * r * B + bits_bytes(r * B)
            + 4 * B * ns, B * ns * _est_ops(r))


def mask_cost(d: int, r: int, c: int, B: int) -> tuple:
    """(bytes, operations) of K3b: the table, off, the sign bits and the
    threshold read, the [d] update written; an estimate, its square and
    the compare a coordinate."""
    return (4 * r * c + 4 * r * B + bits_bytes(r * c) + bits_bytes(r * B)
            + 4 + 4 * d, d * (_est_ops(r) + 2))


def _declare(lib: ctypes.CDLL) -> None:
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.cct_sketch_encode.argtypes = [vp, ll, vp, vp, vp, vp, i, i, i, vp]
    lib.cct_sketch_estimate_all.argtypes = [vp, vp, vp, vp, vp, i, i, i, ll,
                                            i, i, vp]
    lib.cct_sketch_threshold_sample.argtypes = [vp, vp, vp, vp, vp, i, i, i,
                                                ll, i, i, vp]
    lib.cct_sketch_threshold_mask.argtypes = [vp, vp, vp, vp, vp, vp, i, i,
                                              i, ll, vp]
    for fn in (lib.cct_sketch_encode, lib.cct_sketch_estimate_all,
               lib.cct_sketch_threshold_sample,
               lib.cct_sketch_threshold_mask):
        fn.restype = i


def _load() -> ctypes.CDLL:
    return _build.load("sketch", _declare)


def _check_args(tensors: Dict[str, torch.Tensor],
                shapes: Dict[str, tuple]) -> torch.device:
    """dtype / shape / contiguity / one-device checks, raised before any
    pointer reaches the kernel (and on the CPU path too)."""
    dev = None
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        want = (torch.int32 if name == "off" or name.endswith("_bits")
                else torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must have shape {shapes[name]}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev} "
                             "(all operands on one device)")
    return dev


# ---------------------------------------------------------------------------
# K1: encode


def encode_plain(x: torch.Tensor, off: torch.Tensor, delta: torch.Tensor,
                 eps: torch.Tensor, c: int) -> torch.Tensor:
    """table[j] = sum_b roll(eps[j] * chunk_b, off[j, b]) * delta[j, b],
    chunks ascending — the JAX static path (ops/sketch.py encode) op for
    op, so the same additions happen in the same order."""
    r, B = off.shape
    d = x.shape[0]
    pad = B * c - d
    chunks = torch.nn.functional.pad(x, (0, pad)).view(B, c)
    offs = off.tolist()  # graftlint: disable=GL002 -- the plain version, CPU tensors only
    rows = []
    for j in range(r):
        acc = torch.zeros(c, dtype=x.dtype, device=x.device)
        for b in range(B):
            acc = acc + (torch.roll(eps[j] * chunks[b], offs[j][b])
                         * delta[j, b])
        rows.append(acc)
    return torch.stack(rows)


def _words(n: int) -> int:
    """int32 words that hold n sign bits"""
    return -(-n // 32)


def pack_sign_bits(t: torch.Tensor) -> torch.Tensor:
    """The signs of a +-1 table as bits, little-endian in int32 words:
    bit i of the flattened table (word i // 32, bit i % 32) is set iff
    its value is -1. Raises ValueError if any value is not exactly +-1."""
    flat = t.reshape(-1)
    if not bool(((flat == 1.0) | (flat == -1.0)).all()):  # graftlint: disable=GL002,GL004,GL013 -- exact +-1 check, once per device (CSVec.sign_bits caches)
        raise ValueError("sign tables must hold exactly +-1")
    n = flat.numel()
    words = _words(n)
    bits = torch.nn.functional.pad((flat < 0).to(torch.int64),
                                   (0, 32 * words - n)).view(words, 32)
    shifts = torch.arange(32, dtype=torch.int64, device=t.device)
    packed = (bits << shifts).sum(dim=1)                   # in [0, 2^32)
    return torch.where(packed >= 2 ** 31, packed - 2 ** 32,
                       packed).to(torch.int32)


def unpack_sign_bits(bits: torch.Tensor, shape: Tuple[int, ...]
                     ) -> torch.Tensor:
    """The +-1 float32 table of `shape` whose signs `bits` holds: the
    inverse of `pack_sign_bits`."""
    n = 1
    for s in shape:
        n *= s
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    neg = ((bits[:, None] >> shifts) & 1).reshape(-1)[:n]
    return (1.0 - 2.0 * neg.to(torch.float32)).reshape(shape)


def encode(x: torch.Tensor, off: torch.Tensor, delta_bits: torch.Tensor,
           eps_bits: torch.Tensor, c: int) -> torch.Tensor:
    """[r, c] sketch table of the dense [d] vector `x`. The signs come
    as `pack_sign_bits` of delta [r, B] and eps [r, c] (`CSVec.sign_bits`
    keeps them, packed once per device). K1 on a CUDA tensor reads the
    bits; on a CPU tensor `encode_plain` takes the tables they unpack to."""
    r, B = off.shape
    d = x.shape[0]
    dev = _check_args({"x": x, "off": off, "delta_bits": delta_bits,
                       "eps_bits": eps_bits},
                      {"x": (d,), "off": (r, B),
                       "delta_bits": (_words(r * B),),
                       "eps_bits": (_words(r * c),)})
    if B != -(-d // c):
        raise ValueError(f"off has {B} chunks, d={d}, c={c} needs "
                         f"{-(-d // c)}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    with kernel_region("sketch_encode", dev, (x.shape, off.shape),
                       *encode_cost(d, r, c, B)):
        if dev.type == "cpu":
            return encode_plain(x, off, unpack_sign_bits(delta_bits, (r, B)),
                                unpack_sign_bits(eps_bits, (r, c)), c)
        return _encode_cuda(x, off, delta_bits, eps_bits, r, c, B, d, dev)


def _encode_cuda(x, off, delta_bits, eps_bits, r: int, c: int, B: int,
                 d: int, dev) -> torch.Tensor:
    if not 1 <= r <= MAX_ROWS or r * c >= 2 ** 31:
        raise ValueError(f"encode takes 1 <= r <= {MAX_ROWS} rows and "
                         f"r * c < 2^31 on the card, got r={r}, c={c}")
    lib = _load()
    table = torch.empty((r, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.cct_sketch_encode(
            x.data_ptr(), d, off.data_ptr(), delta_bits.data_ptr(),
            eps_bits.data_ptr(), table.data_ptr(), r, c, B, stream)
    _build.check(lib, code, "cct_sketch_encode")
    LAUNCHES["sketch_encode"] += 1
    return table


# ---------------------------------------------------------------------------
# K2: estimate_all


def median_rows(vals: torch.Tensor) -> torch.Tensor:
    """Median over dim 0 with jnp.median's convention: the middle value
    for an odd count, the mean 0.5 * (a + b) of the two middles for an
    even one (torch.median would return the lower middle)."""
    r = vals.shape[0]
    s = torch.sort(vals, dim=0).values
    if r % 2:
        return s[r // 2]
    return (s[r // 2 - 1] + s[r // 2]) * 0.5


def estimate_all_plain(table: torch.Tensor, off: torch.Tensor,
                       delta: torch.Tensor, eps: torch.Tensor, d: int,
                       b0: int = 0, nb: Optional[int] = None
                       ) -> torch.Tensor:
    """est[b - b0, p] = median_j(table[j, (p + off[j, b]) mod c]
    * eps[j, p] * delta[j, b]) for the chunks b0 <= b < b0 + nb (all B by
    default), zero where b * c + p >= d: stacked rolls, sort, middle."""
    r, c = table.shape
    B = off.shape[1]
    nb = B - b0 if nb is None else nb
    offs = off[:, b0:b0 + nb].tolist()  # graftlint: disable=GL002 -- the plain version, CPU tensors only
    ests = []
    for i in range(nb):
        rows = torch.stack([torch.roll(table[j], -offs[j][i])
                            for j in range(r)])
        ests.append(median_rows(rows * eps
                                * delta[:, b0 + i][:, None]))
    est = torch.stack(ests)
    tail = d - b0 * c
    if nb * c > tail:
        est.view(-1)[tail:] = 0.0
    return est


def _check_decode_args(what: str, table: torch.Tensor, off: torch.Tensor,
                       delta_bits: torch.Tensor, eps_bits: torch.Tensor,
                       d: int) -> torch.device:
    """The operand checks K2 and K3 share, the signs as packed bits.
    Returns the device."""
    r, c = table.shape
    B = off.shape[1]
    dev = _check_args({"table": table, "off": off, "delta_bits": delta_bits,
                       "eps_bits": eps_bits},
                      {"table": (r, c), "off": (r, B),
                       "delta_bits": (_words(r * B),),
                       "eps_bits": (_words(r * c),)})
    if B != -(-d // c):
        raise ValueError(f"off has {B} chunks, d={d}, c={c} needs "
                         f"{-(-d // c)}")
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"{what} takes 1 <= r <= {MAX_ROWS} rows, "
                         f"got {r}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def estimate_all(table: torch.Tensor, off: torch.Tensor,
                 delta_bits: torch.Tensor, eps_bits: torch.Tensor,
                 d: int) -> torch.Tensor:
    """[B, c] median-of-rows estimates (tail zeroed), the signs as in
    `encode`: K2 on a CUDA tensor reads the bits; on a CPU tensor
    `estimate_all_plain` takes the tables they unpack to."""
    return _estimate(table, off, delta_bits, eps_bits, d, 0, off.shape[1],
                     "sketch_estimate_all")


def estimate_window(table: torch.Tensor, off: torch.Tensor,
                    delta_bits: torch.Tensor, eps_bits: torch.Tensor,
                    d: int, b0: int, nb: int) -> torch.Tensor:
    """[nb, c]: rows b0 .. b0 + nb - 1 of `estimate_all`'s [B, c], by K2
    on that window alone on a CUDA tensor (counted as
    `sketch_estimate_window`), by `estimate_all_plain` on a CPU one."""
    return _estimate(table, off, delta_bits, eps_bits, d, int(b0), int(nb),
                     "sketch_estimate_window")


def _estimate(table, off, delta_bits, eps_bits, d: int, b0: int, nb: int,
              name: str) -> torch.Tensor:
    r, c = table.shape
    B = off.shape[1]
    dev = _check_decode_args(name, table, off, delta_bits, eps_bits, d)
    if not (0 <= b0 and 1 <= nb and b0 + nb <= B):
        raise ValueError(f"chunk window [{b0}, {b0 + nb}) is not within "
                         f"the {B} chunks")
    with kernel_region(name, dev, (table.shape, off.shape),
                       *estimate_cost(r, c, nb)):
        if dev.type == "cpu":
            return estimate_all_plain(table, off,
                                      unpack_sign_bits(delta_bits, (r, B)),
                                      unpack_sign_bits(eps_bits, (r, c)), d,
                                      b0, nb)
        return _estimate_cuda(table, off, delta_bits, eps_bits, r, c, B, d,
                              b0, nb, name, dev)


def _estimate_cuda(table, off, delta_bits, eps_bits, r: int, c: int, B: int,
                   d: int, b0: int, nb: int, name: str, dev) -> torch.Tensor:
    lib = _load()
    est = torch.empty((nb, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.cct_sketch_estimate_all(
            table.data_ptr(), off.data_ptr(), delta_bits.data_ptr(),
            eps_bits.data_ptr(), est.data_ptr(), r, c, B, d, b0, nb, stream)
    _build.check(lib, code, "cct_sketch_estimate_all")
    LAUNCHES[name] += 1
    return est


# ---------------------------------------------------------------------------
# K3: the sampled-threshold decode (K3a sample, K3b mask)


def threshold_sample_geometry(n_chunks: int, c: int) -> Tuple[int, int]:
    """(stride, per-chunk sample count) of the threshold decode's
    quantile sample: the JAX package's global stride over the padded
    vector, restricted to each chunk. The stride is clamped to c, so
    ns * stride <= c always holds (a chunk narrower than the global
    stride still gives its position-0 element)."""
    padded = n_chunks * c
    stride = min(max(1, padded // _SAMPLE_TARGET), c)
    return stride, c // stride


def threshold_sample_plain(table: torch.Tensor, off: torch.Tensor,
                           delta: torch.Tensor, eps: torch.Tensor, d: int,
                           stride: int, ns: int) -> torch.Tensor:
    """sample[b, s] = the estimate of coordinate b * c + s * stride (0
    at or past d): the gathered signed rows (table * eps) * delta, then
    the median as `median_rows` takes it — K2's arithmetic at the
    sampled positions only."""
    r, c = table.shape
    B = off.shape[1]
    pos = torch.arange(ns, device=table.device) * stride          # [ns]
    q = (pos[None, None, :] + off[:, :, None].long()) % c         # [r,B,ns]
    rows = torch.arange(r, device=table.device)[:, None, None]
    vals = table[rows, q] * eps[:, pos][:, None, :] * delta[:, :, None]
    sample = median_rows(vals)                                    # [B, ns]
    gidx = (torch.arange(B, device=table.device)[:, None] * c
            + pos[None, :])
    return torch.where(gidx < d, sample, torch.zeros_like(sample))


def threshold_sample(table: torch.Tensor, off: torch.Tensor,
                     delta_bits: torch.Tensor, eps_bits: torch.Tensor,
                     d: int, stride: int, ns: int) -> torch.Tensor:
    """[B, ns] estimates at chunk positions 0, stride, ...,
    (ns - 1) * stride, the tail zeroed. The signs come as in `encode`:
    K3a on a CUDA tensor reads the bits; on a CPU tensor
    `threshold_sample_plain` takes the tables they unpack to."""
    r, c = table.shape
    B = off.shape[1]
    dev = _check_decode_args("threshold_sample", table, off, delta_bits,
                             eps_bits, d)
    if stride < 1 or ns < 1 or (ns - 1) * stride >= c:
        raise ValueError(f"stride={stride}, ns={ns} leave chunk positions "
                         f"[0, {c})")
    with kernel_region("threshold_sample", dev, (table.shape, off.shape),
                       *sample_cost(r, c, B, ns)):
        if dev.type == "cpu":
            return threshold_sample_plain(
                table, off, unpack_sign_bits(delta_bits, (r, B)),
                unpack_sign_bits(eps_bits, (r, c)), d, stride, ns)
        return _sample_cuda(table, off, delta_bits, eps_bits, r, c, B, d,
                            stride, ns, dev)


def _sample_cuda(table, off, delta_bits, eps_bits, r: int, c: int, B: int,
                 d: int, stride: int, ns: int, dev) -> torch.Tensor:
    lib = _load()
    sample = torch.empty((B, ns), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.cct_sketch_threshold_sample(
            table.data_ptr(), off.data_ptr(), delta_bits.data_ptr(),
            eps_bits.data_ptr(), sample.data_ptr(), r, c, B, d, stride, ns,
            stream)
    _build.check(lib, code, "cct_sketch_threshold_sample")
    LAUNCHES["threshold_sample"] += 1
    return sample


def threshold_mask_plain(table: torch.Tensor, off: torch.Tensor,
                         delta: torch.Tensor, eps: torch.Tensor,
                         thr: torch.Tensor, d: int) -> torch.Tensor:
    """[d] vector: every estimate whose square is >= thr (ties kept),
    zero elsewhere — K2's estimate, then the select."""
    est = estimate_all_plain(table, off, delta, eps, d).reshape(-1)[:d]
    return torch.where(est * est >= thr, est, torch.zeros_like(est))


def threshold_mask(table: torch.Tensor, off: torch.Tensor,
                   delta_bits: torch.Tensor, eps_bits: torch.Tensor,
                   thr: torch.Tensor, d: int) -> torch.Tensor:
    """The thresholded [d] update, the signs as in `encode`: K3b on a
    CUDA tensor (it reads the bits, and `thr`, a one-element f32 tensor,
    from device memory: no host sync); on a CPU tensor
    `threshold_mask_plain` takes the tables the bits unpack to."""
    r, c = table.shape
    B = off.shape[1]
    dev = _check_decode_args("threshold_mask", table, off, delta_bits,
                             eps_bits, d)
    if not isinstance(thr, torch.Tensor) or thr.numel() != 1:
        raise ValueError("thr must be a one-element tensor")
    if thr.dtype != torch.float32 or thr.device != dev:
        raise ValueError(f"thr must be float32 on {dev}, got {thr.dtype} "
                         f"on {thr.device}")
    with kernel_region("threshold_mask", dev, (table.shape, off.shape),
                       *mask_cost(d, r, c, B)):
        if dev.type == "cpu":
            return threshold_mask_plain(
                table, off, unpack_sign_bits(delta_bits, (r, B)),
                unpack_sign_bits(eps_bits, (r, c)), thr, d)
        return _mask_cuda(table, off, delta_bits, eps_bits, thr, r, c, B, d,
                          dev)


def _mask_cuda(table, off, delta_bits, eps_bits, thr, r: int, c: int,
               B: int, d: int, dev) -> torch.Tensor:
    lib = _load()
    thr = thr.reshape(1).contiguous()
    out = torch.empty((d,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.cct_sketch_threshold_mask(
            table.data_ptr(), off.data_ptr(), delta_bits.data_ptr(),
            eps_bits.data_ptr(), thr.data_ptr(), out.data_ptr(), r, c, B, d,
            stream)
    _build.check(lib, code, "cct_sketch_threshold_mask")
    LAUNCHES["threshold_mask"] += 1
    return out
