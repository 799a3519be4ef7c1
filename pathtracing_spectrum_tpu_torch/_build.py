"""Build the port's native code at first use and bind it with ctypes.

Two shared libraries, each built into ``build/`` next to this file
(``.gitignore`` lists it) on the machine that uses it:

- the CUDA kernels under ``csrc/*.cu`` (with the shared header
  ``csrc/tri_hit.cuh``), by nvcc, one object per source compiled in
  parallel, then linked; only the machine with the card builds it;
- the host library, by the host C++ compiler, one object per source
  compiled in parallel, then linked, on any machine that uses it (the CPU
  tests too): the BVH builder ``csrc/bvh_build.cpp``, the OBJ
  parser and spectral writer ``csrc/host_io.cpp``, the JPEG decoder
  ``csrc/jpeg_decode.cpp`` (which also reads JPEG-compressed TIFF strips
  as libtiff does) and encoder ``csrc/jpeg_encode.cpp``, the
  LZW, PackBits, SGI RLE and PCX RLE decoders ``csrc/lzw_decode.cpp``,
  the CCITT (fax) decoder of TIFF compressions 2, 3 and 4
  ``csrc/fax_decode.cpp``, the Zstandard decoder of TIFF compression
  50000 ``csrc/zstd_decode.cpp``, the QOI decoder and encoder ``csrc/qoi.cpp``,
  the DDS block (BC1-BC7) and BLP2 DXT decoder
  ``csrc/bcn_decode.cpp``, PIL's LANCZOS and BICUBIC resampler ``csrc/resample.cpp``,
  the WebP decoder ``csrc/webp_decode.cpp`` and encoder ``csrc/webp_encode.cpp`` (with
  their shared VP8 tables and transforms ``csrc/vp8_common.h``), the
  GIF quantiser and LZW encoder ``csrc/gif_encode.cpp`` and the JPEG
  2000 decoder ``csrc/j2k_decode.cpp`` and encoder ``csrc/j2k_encode.cpp``
  (with their shared tables and forward 5/3 transform
  ``csrc/j2k_common.h``), the FLI/FLC frame decoder
  ``csrc/fli_decode.cpp`` and LittleCMS's Lab to sRGB interpolation
  ``csrc/lab_srgb.cpp``.

Each file name carries a hash of its sources and flags, so a changed source
is always rebuilt and a stale library is never loaded. Processes that need
a missing library at once (test workers, the ranks of one job) take a
``flock`` on a lock file beside it: one builds, the others wait and load
what it built. Nothing here runs at import: the CPU tests import every
module on machines without nvcc.

Each CUDA entry point takes device pointers and the stream as ``void*``,
launches on that stream, and returns ``cudaGetLastError()``; the wrappers
raise when it is not 0.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
SOURCES = (_CSRC / "intersect_dense.cu", _CSRC / "fetch_rows.cu",
           _CSRC / "intersect_bvh.cu", _CSRC / "intersect_cluster.cu",
           _CSRC / "threefry.cu")
HEADERS = (_CSRC / "tri_hit.cuh",)
HOST_SOURCES = (_CSRC / "bvh_build.cpp", _CSRC / "host_io.cpp",
                _CSRC / "jpeg_decode.cpp", _CSRC / "jpeg_encode.cpp",
                _CSRC / "lzw_decode.cpp", _CSRC / "webp_decode.cpp",
                _CSRC / "gif_encode.cpp", _CSRC / "webp_encode.cpp",
                _CSRC / "fax_decode.cpp", _CSRC / "qoi.cpp",
                _CSRC / "bcn_decode.cpp", _CSRC / "resample.cpp",
                _CSRC / "j2k_encode.cpp", _CSRC / "j2k_decode.cpp",
                _CSRC / "zstd_decode.cpp", _CSRC / "fli_decode.cpp",
                _CSRC / "lab_srgb.cpp")
HOST_HEADERS = (_CSRC / "jpeg_std_tables.h", _CSRC / "vp8_common.h",
                _CSRC / "j2k_common.h")
BUILD_DIR = _HERE / "build"

# sm_90a (Hopper); --fmad=false keeps every multiply and add separately
# rounded, as the plain torch versions compute them.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")
# the flags the JAX package builds its native library with
# (pathtracing_spectrum_tpu/native/__init__.py), so that both compile the
# same SAH arithmetic (the same tree), the same strtof (the same OBJ
# coordinates) and the same to_chars (the same export text)
HOST_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-march=native")

_V, _I = ctypes.c_void_p, ctypes.c_int
_I32, _I64, _U32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint32
# C signatures: device pointers, sizes, stream; each returns cudaError_t.
_SIGNATURES = {
    "pts_intersect_dense": [_V] * 6 + [_V, _I, _I] + [_V] * 5 + [_V],
    "pts_fetch_rows": [_V, _V, _I, _I, _I, _V, _V],
    "pts_intersect_bvh": [_V] * 6 + [_V, _V, _I, _I, _V, _V] + [_V] * 5
                         + [_V],
    "pts_intersect_cluster": [_V] * 6 + [_V, _V, _V, _I, _I, _I, _V]
                             + [_V] * 5 + [_V],
    "pts_threefry_uniform": [_U32, _U32, _I64, _V, _V],
}
_S = ctypes.c_char_p
_HOST_SIGNATURES = {
    "pts_bvh_build": ([_V, _V, _I64, _I32], _V),
    "pts_bvh_node_count": ([_V], _I32),
    "pts_bvh_export": ([_V] * 7, None),
    "pts_bvh_free": ([_V], None),
    "pts_obj_load": ([_S], _V),
    "pts_obj_counts": ([_V] * 5, None),
    "pts_obj_copy_attribs": ([_V] * 4, None),
    "pts_obj_shape_faces": ([_V, _I32], _I32),
    "pts_obj_shape_name": ([_V, _I32, _S, _I32], _I32),
    "pts_obj_shape_indices": ([_V, _I32] + [_V] * 4, None),
    "pts_obj_free": ([_V], None),
    "pts_export_spectrum": ([_S, _V, _I32, _I32, _I32], _I32),
    "pts_jpeg_decode": ([_V, _I64, _I32, _V, _S, _I32], _V),
    "pts_jpeg_size": ([_V, _V, _V, _V], None),
    "pts_jpeg_copy": ([_V, _V], None),
    "pts_jpeg_free": ([_V], None),
    "pts_jpeg_encode": ([_V, _I32, _I32, _I32], _V),
    "pts_jpeg_tables": ([_V, _I64, _V, _S, _I32], _V),
    "pts_jpeg_tables_free": ([_V], None),
    "pts_jpeg_tiff_decode": ([_V, _V, _I64] + [_I32] * 8 + [_V, _S, _I32],
                             _V),
    "pts_gif_quantize": ([_V, _I64, _V, _V], _I32),
    "pts_gif_lzw_encode": ([_V, _I32, _I32, _I32, _I64], _V),
    "pts_buffer_size": ([_V], _I64),
    "pts_buffer_copy": ([_V, _V], None),
    "pts_buffer_free": ([_V], None),
    "pts_gif_lzw_decode": ([_V, _I64, _I32, _V, _I64, _V], _I32),
    "pts_tiff_lzw_decode": ([_V, _I64, _V, _I64], _I32),
    "pts_packbits_decode": ([_V, _I64, _V, _I64, _I64], _I32),
    "pts_sgi_rle_decode": ([_V, _I64, _I32, _I32, _I32, _I32, _V], _I32),
    "pts_pcx_decode": ([_V, _I64, _I32, _I32, _I64, _I32, _V], _I32),
    "pts_bmp_rle_decode": ([_V, _I64, _I64, _I32, _I32, _I32, _V], _I32),
    "pts_icns_rle_decode": ([_V, _I64, _I64, _I64, _V], _I32),
    "pts_fax_run_slots": ([_I32, _I32, _I32], _I64),
    "pts_fax_decode": ([_V, _I64, _I32, _I32, _I32, _I32, _I64] + [_V] * 4,
                       _I32),
    "pts_tiff_zstd_decode": ([_V, _I64, _V, _I64], _I32),
    "pts_qoi_decode": ([_V, _I64, _I32, _I64, _V], _I32),
    "pts_qoi_encode": ([_V, _I64, _V], _I64),
    "pts_bcn_decode": ([_V, _I64] + [_I32] * 4 + [_V], _I32),
    "pts_blp_dxt_decode": ([_V, _I64] + [_I32] * 4 + [_V], _I32),
    "pts_resample": ([_V] + [_I32] * 6 + [_V], _I32),
    "pts_webp_decode": ([_V, _I64, _V, _S, _I32], _V),
    "pts_webp_size": ([_V, _V, _V], None),
    "pts_webp_copy": ([_V, _V], None),
    "pts_webp_free": ([_V], None),
    "pts_webp_encode": ([_V, _I32, _I32, _I32, _V], _V),
    "pts_webp_encode_stages": ([_V, _I32, _I32, _I32] + [_V] * 5, _I32),
    "pts_j2k_encode": ([_V, _I32, _I32, _I32], _V),
    "pts_j2k_decode": ([_V, _I64, _V, _S, _I32], _V),
    "pts_j2k_size": ([_V, _V, _V, _V], None),
    "pts_j2k_copy": ([_V, _V], None),
    "pts_j2k_free": ([_V], None),
    "pts_fli_decode": ([_V, _I64, _I32, _I32, _V], _I32),
    "pts_lab_srgb": ([_V, _V, _I64, _I32, _V], None),
}


class _Library:
    lib = None
    host = None
    build_seconds = 0.0


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels are built at first use")
    return found


def host_compiler() -> str:
    for name in (os.environ.get("CXX", ""), "c++", "g++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    raise RuntimeError("no host C++ compiler (set CXX or put c++ on PATH); "
                       "the host library is built at first use")


def _hashed(stem: str, flags, files) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def library_path() -> Path:
    return _hashed("libpts_torch_kernels", NVCC_FLAGS, SOURCES + HEADERS)


def host_library_path() -> Path:
    return _hashed("libpts_torch_host", HOST_FLAGS,
                   HOST_SOURCES + HOST_HEADERS)


def _run_all(cmds) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    failed = None
    for cmd, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0 and failed is None:
            failed = (cmd, p.returncode, out)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"build failed ({rc}):\n{' '.join(cmd)}\n{out}")


@contextlib.contextmanager
def _build_lock(path: Path):
    """Hold an exclusive ``flock`` on ``path``'s lock file in ``BUILD_DIR``
    (the kernel and host libraries have their own, so they build side by
    side); the kernel drops it if the holder dies."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(path.with_suffix(".lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _build(path: Path, make) -> bool:
    """Build ``path`` unless another process has, under its lock:
    ``make(tmp_stem)`` runs the compilers, and the result is moved in place
    atomically. True where this process built it."""
    with _build_lock(path):
        if path.exists():
            return False
        stem = path.with_suffix(f".{os.getpid()}")
        tmp = make(stem)
        os.replace(tmp, path)
        return True


def _objects_then_link(stem: Path, compiler: str, flags, sources) -> Path:
    """Compile each of ``sources`` to an object, side by side, then link
    the objects into ``stem.tmp`` (``flags`` without ``-shared`` compile,
    with it they link)."""
    compile_flags = [f for f in flags if f != "-shared"]
    objs = [Path(f"{stem}.{src.stem}.o") for src in sources]
    _run_all([[compiler, *compile_flags, "-c", "-o", str(o), str(s)]
              for o, s in zip(objs, sources)])
    tmp = Path(f"{stem}.tmp")
    _run_all([[compiler, *compile_flags, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]])
    for o in objs:
        o.unlink()
    return tmp


def _make_kernels(stem: Path) -> Path:
    return _objects_then_link(stem, nvcc_path(), NVCC_FLAGS, SOURCES)


def _make_host(stem: Path) -> Path:
    return _objects_then_link(stem, host_compiler(), HOST_FLAGS,
                              HOST_SOURCES)


def load() -> ctypes.CDLL:
    """Build (when the hashed library is missing) and load the kernels."""
    if _Library.lib is not None:
        return _Library.lib
    path = library_path()
    if not path.exists():
        t0 = time.perf_counter()
        if _build(path, _make_kernels):
            _Library.build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _Library.lib = lib
    return lib


def load_host() -> ctypes.CDLL:
    """Build (when the hashed library is missing) and load the host
    library: the BVH builder, the OBJ parser, the spectral writer, the
    JPEG decoder and encoder, the LZW, PackBits, SGI RLE, PCX RLE, BMP RLE,
    ICNS RLE, CCITT and Zstandard decoders, the QOI decoder and encoder, the DDS block decoder,
    the resampler, the WebP decoder and encoder, the GIF encoder and the
    JPEG 2000 decoder and encoder, the FLI/FLC decoder and the Lab to
    sRGB interpolation. Raises with the
    compiler's output when it cannot be built: none of them has a
    fallback."""
    if _Library.host is not None:
        return _Library.host
    path = host_library_path()
    if not path.exists():
        _build(path, _make_host)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _HOST_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    _Library.host = lib
    return lib


def build_seconds() -> float:
    """nvcc wall time of this process's kernel build (0.0 if it found
    one)."""
    return _Library.build_seconds


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
