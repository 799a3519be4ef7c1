"""The binding of the host library's LZW, PackBits, SGI RLE and PCX RLE
decoders (``csrc/lzw_decode.cpp``) and its CCITT decoder
(``csrc/fax_decode.cpp``), which the GIF, TIFF, PSD, SGI and PCX readers
of ``utils/image.py`` run. They are serial over codes, packets or bits,
so host C++ (a 2048x2048 LZW strip or bilevel map would take minutes in
Python, and a 4K PCX holds ~25 M bytes of runs), with no Python fallback:
when the host library cannot be built, the call raises with the
compiler's output.

Each function returns the decoded bytes, or raises :class:`BrokenData`
where PIL (for GIF, PSD, SGI and PCX) or libtiff (for TIFF) rejects the
data.
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


def sgi_rle(data: bytes, width: int, height: int, bands: int,
            bpc: int) -> np.ndarray:
    """The rows of an RLE SGI file (``data`` is the whole file) as PIL's
    SgiRleDecode.c expands them: [height, width * bands * bpc] uint8, each
    row its channels interleaved, ``bpc`` bytes a sample as stored
    (big-endian), in file order (bottom-up); where PIL stops without an
    error (a row's last packet is not the end), that row and the rest are
    zeros."""
    lib = _build.load_host()
    buf, ptr = _source(data)
    out = np.zeros((height, width * bands * bpc), np.uint8)
    if lib.pts_sgi_rle_decode(ptr, buf.size, width, height, bands, bpc,
                              out.ctypes.data):
        raise BrokenData("broken SGI run-length data")
    return out


def pcx_rle(data: bytes, width: int, bits: int, line_bytes: int,
            height: int) -> np.ndarray:
    """[height, line_bytes] uint8: the lines of PCX image data (``data``
    starts at the first packet) as PIL's PcxDecode.c leaves them in its
    line buffer, the planes moved together where it moves them (``bits``:
    the rawmode's bits a pixel, 1, 2, 4, 8 or 24)."""
    lib = _build.load_host()
    buf, ptr = _source(data)
    out = np.zeros((height, line_bytes), np.uint8)
    if lib.pts_pcx_decode(ptr, buf.size, width, bits, line_bytes, height,
                          out.ctypes.data):
        raise BrokenData("broken PCX run-length data")
    return out


class Fax:
    """libtiff 4.7's CCITT decoder (tif_fax3.c) over the strips or tiles
    of one image: TIFF compression 2 (Modified Huffman, rows byte-aligned),
    3 (T.4 with EOLs; ``options`` its T4Options, bit 0 the 2-D rows) or 4
    (T.6), ``width`` pixels a row. It keeps what libtiff keeps between
    them: its run array (a damaged 2-D row may read stale runs) and its
    mode (a strip of compression 3 that had no EOLs was read again without
    them, and so are the strips after it). ``csrc/fax_decode.cpp`` lists
    the damage it recovers from as libtiff does."""

    _MODES = {2: 7, 3: 0, 4: 1}   # FAXMODE_NORTC | NOEOL | BYTEALIGN ...

    def __init__(self, scheme: int, options: int, width: int):
        lib = _build.load_host()
        self.scheme, self.options, self.width = scheme, options, width
        self._runs = np.zeros(lib.pts_fax_run_slots(scheme, options, width),
                              np.uint32)
        self._mode = ctypes.c_int32(self._MODES[scheme])

    def decode(self, data: bytes, out: np.ndarray) -> np.ndarray:
        """Decode one strip or tile (fill order 1) into ``out``, [rows, row
        bytes] uint8, whose rows the decoder does not write keep their
        bytes (compression 4 stops at the end of its data without an error
        once a row is written); returns the rows written, [rows] bool.
        Raises :class:`BrokenData` where libtiff fails."""
        lib = _build.load_host()
        buf, ptr = _source(data)
        rows, row_bytes = out.shape
        written = np.zeros(max(rows, 1), np.uint8)
        if lib.pts_fax_decode(ptr, buf.size, self.scheme, self.options,
                              self.width, rows, row_bytes, out.ctypes.data,
                              written.ctypes.data, self._runs.ctypes.data,
                              ctypes.byref(self._mode)) != 1:
            raise BrokenData("broken CCITT data")
        return written[:rows].astype(bool)
