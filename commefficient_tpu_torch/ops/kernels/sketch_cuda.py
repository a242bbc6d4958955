"""Count-sketch encode (K1) and estimate-all (K2): CUDA kernels for
Hopper with their plain PyTorch versions.

K1 `encode` replaces commefficient_tpu/ops/kernels/sketch_pallas.py
`pallas_encode` (`_encode_kernel`); K2 `estimate_all` replaces
`pallas_estimate_all` (`_estimate_kernel`, `_chunk_estimate_rows`,
`_masked_est`, `_median_rows`). The kernels live in ../csrc/sketch.cu,
whose header says how each is designed for the card and what bounds
it (bytes: about 46 MB and 48 MB at d = 6.57M, r = 5, c = 500k).

Routing is by device, per call: a CPU tensor takes the plain version
(the CPU tests' path); a CUDA tensor launches the kernel or raises.
There is no fallback from the card to the plain version.

Build: `nvcc -gencode arch=compute_90a,code=sm_90a` into a shared
library with a plain C interface (loaded with ctypes), at first use,
into the checkout's `build/` directory. The library's name carries a
hash of the source and flags, so an edited source is rebuilt.

Counts: `LAUNCHES[name]` adds one each time the wrapper launches the
kernel, and nowhere else (chip_smoke.py reads them around the main
path).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO / "build"

# one shared library per source file; each is built by its own nvcc
SOURCES = {"sketch": _CSRC / "sketch.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

# kernel name -> launches through its wrapper (plain versions never count)
LAUNCHES: Dict[str, int] = {"sketch_encode": 0, "sketch_estimate_all": 0}

# the largest row count K2's register sort network is instantiated for
MAX_ROWS = 16

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
# what each build printed (nvcc / ptxas register and spill report)
BUILD_LOG: Dict[str, str] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels are built from source at first use")
    return found


def _lib_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libcct_{name}_{digest}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, Path]:
    """Compile the named sources (all by default) that are not built
    yet, one nvcc process per source, all started together. Returns
    the library paths. Raises RuntimeError with nvcc's output if a
    build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[n] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n].name} "
                          f"(exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, todo[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def _load(name: str) -> ctypes.CDLL:
    with _build_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if name == "sketch":
            lib.cct_sketch_encode.argtypes = [vp, ll, vp, vp, vp, vp,
                                              i, i, i, vp]
            lib.cct_sketch_encode.restype = i
            lib.cct_sketch_estimate_all.argtypes = [vp, vp, vp, vp, vp,
                                                    i, i, i, ll, vp]
            lib.cct_sketch_estimate_all.restype = i
            lib.cct_error_string.argtypes = [i]
            lib.cct_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def _check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.cct_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def _check_args(tensors: Dict[str, torch.Tensor],
                shapes: Dict[str, tuple]) -> torch.device:
    """dtype / shape / contiguity / one-device checks, raised before any
    pointer reaches the kernel (and on the CPU path too)."""
    dev = None
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        want = torch.int32 if name == "off" else torch.float32
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
    offs = off.tolist()
    rows = []
    for j in range(r):
        acc = torch.zeros(c, dtype=x.dtype, device=x.device)
        for b in range(B):
            acc = acc + (torch.roll(eps[j] * chunks[b], offs[j][b])
                         * delta[j, b])
        rows.append(acc)
    return torch.stack(rows)


def encode(x: torch.Tensor, off: torch.Tensor, delta: torch.Tensor,
           eps: torch.Tensor, c: int) -> torch.Tensor:
    """[r, c] sketch table of the dense [d] vector `x`: K1 on a CUDA
    tensor, `encode_plain` on a CPU tensor."""
    r, B = off.shape
    d = x.shape[0]
    dev = _check_args({"x": x, "off": off, "delta": delta, "eps": eps},
                      {"x": (d,), "off": (r, B), "delta": (r, B),
                       "eps": (r, c)})
    if B != -(-d // c):
        raise ValueError(f"off has {B} chunks, d={d}, c={c} needs "
                         f"{-(-d // c)}")
    if dev.type == "cpu":
        return encode_plain(x, off, delta, eps, c)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _load("sketch")
    table = torch.empty((r, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.cct_sketch_encode(
            x.data_ptr(), d, off.data_ptr(), delta.data_ptr(),
            eps.data_ptr(), table.data_ptr(), r, c, B, stream)
    _check(lib, code, "cct_sketch_encode")
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
                       delta: torch.Tensor, eps: torch.Tensor,
                       d: int) -> torch.Tensor:
    """est[b, p] = median_j(table[j, (p + off[j, b]) mod c] * eps[j, p]
    * delta[j, b]), tail (b * c + p >= d) zeroed: stacked rolls, sort,
    middle."""
    r, c = table.shape
    B = off.shape[1]
    offs = off.tolist()
    ests = []
    for b in range(B):
        rows = torch.stack([torch.roll(table[j], -offs[j][b])
                            for j in range(r)])
        ests.append(median_rows(rows * eps * delta[:, b][:, None]))
    est = torch.stack(ests)
    if B * c != d:
        est.view(-1)[d:] = 0.0
    return est


def estimate_all(table: torch.Tensor, off: torch.Tensor,
                 delta: torch.Tensor, eps: torch.Tensor,
                 d: int) -> torch.Tensor:
    """[B, c] median-of-rows estimates (tail zeroed): K2 on a CUDA
    tensor, `estimate_all_plain` on a CPU tensor."""
    r, c = table.shape
    B = off.shape[1]
    dev = _check_args({"table": table, "off": off, "delta": delta,
                       "eps": eps},
                      {"table": (r, c), "off": (r, B), "delta": (r, B),
                       "eps": (r, c)})
    if B != -(-d // c):
        raise ValueError(f"off has {B} chunks, d={d}, c={c} needs "
                         f"{-(-d // c)}")
    if not 1 <= r <= MAX_ROWS:
        raise ValueError(f"estimate_all takes 1 <= r <= {MAX_ROWS} rows, "
                         f"got {r}")
    if dev.type == "cpu":
        return estimate_all_plain(table, off, delta, eps, d)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _load("sketch")
    est = torch.empty((B, c), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.cct_sketch_estimate_all(
            table.data_ptr(), off.data_ptr(), delta.data_ptr(),
            eps.data_ptr(), est.data_ptr(), r, c, B, d, stream)
    _check(lib, code, "cct_sketch_estimate_all")
    LAUNCHES["sketch_estimate_all"] += 1
    return est
