"""Build and load the port's CUDA kernel libraries.

Each source in `ops/csrc/` is compiled by its own `nvcc -gencode
arch=compute_90a,code=sm_90a` into a shared library with a plain C
interface, at first use, into the checkout's `build/` directory, and
loaded with ctypes. The library's name carries a hash of the source and
flags, so an edited source is rebuilt. `build()` starts one nvcc per
source, all together.

Every C entry point returns `cudaGetLastError()` after its launch (0 =
launched); `check()` raises on anything else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
_REPO = Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO / "build"

# one shared library per source file; each is built by its own nvcc
SOURCES = {"sketch": _CSRC / "sketch.cu",
           "flash_fwd": _CSRC / "flash_fwd.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()
# what each build printed (nvcc / ptxas register and spill report)
BUILD_LOG: Dict[str, str] = {}
# nvcc processes started by this process (analysis/runtime.count_programs
# counts the builds inside its block)
BUILDS = {"nvcc": 0}


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


def lib_path(name: str) -> Path:
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
    paths = {n: lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
        BUILDS["nvcc"] += 1
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


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library of source `name`, built if needed and loaded once;
    `declare(lib)` sets the argtypes and restypes of its entry points."""
    with _build_lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        declare(lib)
        lib.cct_error_string.argtypes = [ctypes.c_int]
        lib.cct_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.cct_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
