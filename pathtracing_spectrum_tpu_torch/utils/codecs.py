"""The binding of the host library's LZW and PackBits decoders
(``csrc/lzw_decode.cpp``), which the GIF, TIFF and PSD readers of
``utils/image.py`` run. They are bit-serial, so host C++ (a 2048x2048 LZW
strip would take minutes in Python), with no Python fallback: when the
host library cannot be built, the call raises with the compiler's output.

Each function returns the decoded bytes, or raises :class:`BrokenData`
where PIL (for GIF and PSD) or libtiff (for TIFF) rejects the data.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build


class BrokenData(ValueError):
    """Compressed data PIL or libtiff rejects."""


def _source(data: bytes):
    buf = np.frombuffer(data, np.uint8)
    return buf, buf.ctypes.data if buf.size else None


def gif_lzw(data: bytes, bits: int, npix: int) -> np.ndarray:
    """The first ``npix`` (or, where the end code comes first, fewer)
    colour indices of GIF image data: ``data`` starts at the first
    sub-block's length byte, ``bits`` is the LZW minimum code size."""
    lib = _build.load_host()
    buf, ptr = _source(data)
    out = np.zeros(max(npix, 1), np.uint8)
    produced = ctypes.c_int64(0)
    if lib.pts_gif_lzw_decode(ptr, buf.size, bits, out.ctypes.data, npix,
                              ctypes.byref(produced)):
        raise BrokenData("broken GIF image data")
    return out[:produced.value]


def tiff_lzw(data: bytes, nbytes: int) -> np.ndarray:
    """``nbytes`` bytes of a TIFF LZW strip or tile."""
    lib = _build.load_host()
    buf, ptr = _source(data)
    out = np.zeros(max(nbytes, 1), np.uint8)
    if lib.pts_tiff_lzw_decode(ptr, buf.size, out.ctypes.data, nbytes):
        raise BrokenData("broken LZW data")
    return out[:nbytes]


def packbits(data: bytes, row_bytes: int, rows: int = 0) -> np.ndarray:
    """PackBits: ``rows == 0`` decodes one buffer of ``row_bytes`` as
    libtiff does; ``rows > 0`` decodes that many rows as PIL's PSD plugin
    does, dropping what a packet holds past the end of a row."""
    lib = _build.load_host()
    buf, ptr = _source(data)
    n = row_bytes * max(rows, 1)
    out = np.zeros(max(n, 1), np.uint8)
    if lib.pts_packbits_decode(ptr, buf.size, out.ctypes.data, row_bytes,
                               rows):
        raise BrokenData("broken PackBits data")
    return out[:n]
