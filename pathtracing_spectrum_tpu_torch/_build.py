"""Build the CUDA kernels under ``csrc/`` with nvcc and bind them with ctypes.

The shared library is built at first use, on the machine with the card,
into ``build/`` next to this file (``.gitignore`` lists it). Its file name
carries a hash of the sources and the flags, so a changed source is always
rebuilt and a stale library is never loaded. Nothing here runs at import:
the CPU tests import every module on machines without nvcc.

Each C entry point takes device pointers and the stream as ``void*``,
launches on that stream, and returns ``cudaGetLastError()``; the wrappers
raise when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "csrc" / "intersect_dense.cu",
           _HERE / "csrc" / "fetch_rows.cu")
BUILD_DIR = _HERE / "build"

# sm_90a (Hopper); --fmad=false keeps every multiply and add separately
# rounded, as the plain torch versions compute them.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_V, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: device pointers, sizes, stream; each returns cudaError_t.
_SIGNATURES = {
    "pts_intersect_dense": [_V] * 6 + [_V, _I, _I] + [_V] * 5 + [_V],
    "pts_fetch_rows": [_V, _V, _I, _I, _I, _V, _V],
}


class _Library:
    lib = None
    build_seconds = 0.0


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built at first use")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpts_torch_kernels_{h.hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """Build (when the hashed library is missing) and load the kernels."""
    if _Library.lib is not None:
        return _Library.lib
    path = library_path()
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(s) for s in SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
        _Library.build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _Library.lib = lib
    return lib


def build_seconds() -> float:
    """nvcc wall time of this process's build (0.0 if it found one)."""
    return _Library.build_seconds


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
