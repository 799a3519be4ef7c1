"""The binding of the host library's LZW, PackBits, SGI RLE, PCX RLE, BMP
RLE and ICNS RLE decoders (``csrc/lzw_decode.cpp``), its CCITT decoder
(``csrc/fax_decode.cpp``), its Zstandard decoder (``csrc/zstd_decode.cpp``),
its QOI decoder and encoder (``csrc/qoi.cpp``)
and its DDS and BLP block decoders (``csrc/bcn_decode.cpp``), which the
GIF, TIFF, PSD, SGI, PCX, BMP, DIB, ICO, CUR, ICNS, QOI, DDS, BLP and FTEX
readers and the QOI writer of ``utils/image.py`` run. They are serial
over codes, packets, ops or bits, so host C++ (a 2048x2048 LZW strip, bilevel map or QOI
stream would take minutes in Python, and a 4K PCX holds ~25 M bytes of
runs), with no Python fallback: when the host library cannot be built,
the call raises with the compiler's output.

Each decoder returns the decoded bytes, or raises :class:`BrokenData`
where PIL (for GIF, PSD, SGI, PCX, BMP, ICNS, QOI, DDS, BLP and FTEX) or
libtiff (for TIFF) rejects the data.
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


def tiff_zstd(data: bytes, nbytes: int) -> np.ndarray:
    """``nbytes`` bytes of a TIFF ZSTD strip or tile, as libtiff reads them
    through libzstd: the first frame only, a frame longer than the strip
    cut (``csrc/zstd_decode.cpp`` lists libzstd's rules it copies)."""
    lib = _build.load_host()
    buf, ptr = _source(data)
    out = np.zeros(max(nbytes, 1), np.uint8)
    if lib.pts_tiff_zstd_decode(ptr, buf.size, out.ctypes.data, nbytes):
        raise BrokenData("broken ZSTD data")
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


def bmp_rle(data: bytes, pos: int, width: int, height: int,
            rle4: bool) -> np.ndarray:
    """[height, width] uint8 palette indices of BMP RLE8 (or, ``rle4``,
    RLE4) packets from ``data[pos]`` (``data`` is the whole file: an
    absolute run is word-aligned by its offset in it) as PIL's
    BmpRleDecoder decodes them, in its order (a bottom-up file's bottom
    row first); ``csrc/lzw_decode.cpp`` lists its quirks."""
    lib = _build.load_host()
    buf, ptr = _source(data)
    out = np.zeros((height, width), np.uint8)
    if lib.pts_bmp_rle_decode(ptr, buf.size, pos, width, height, int(rle4),
                              out.ctypes.data):
        raise BrokenData("not enough BMP run-length data")
    return out


def icns_rle(data: bytes, pos: int, npix: int) -> np.ndarray:
    """[3, npix] uint8: the R, G and B planes of an ICNS 24-bit RLE entry
    whose packets start at ``data[pos]``, as PIL's ``read_32`` reads them
    (on past the entry where the file goes on)."""
    lib = _build.load_host()
    buf, ptr = _source(data)
    out = np.zeros((3, max(npix, 1)), np.uint8)
    if lib.pts_icns_rle_decode(ptr, buf.size, pos, npix, out.ctypes.data):
        raise BrokenData("error reading an ICNS channel")
    return out[:, :npix]


def qoi(data: bytes, width: int, height: int, bands: int) -> np.ndarray:
    """[height, width, bands] uint8 (3: RGB, 4: RGBA) of the QOI ops in
    ``data`` (the bytes after the 14-byte header), as PIL's QoiDecoder
    decodes them (``csrc/qoi.cpp`` lists where that is not qoi.h)."""
    lib = _build.load_host()
    buf, ptr = _source(data)
    out = np.zeros((height, width, bands), np.uint8)
    if lib.pts_qoi_decode(ptr, buf.size, bands, width * height,
                          out.ctypes.data):
        raise BrokenData("QOI data ends before the last pixel")
    return out


def qoi_encode(rgb: np.ndarray) -> bytes:
    """The QOI ops (the 8-byte padding included, the header not) PIL's
    QoiEncoder writes for [H, W, 3] uint8 RGB."""
    lib = _build.load_host()
    img = np.ascontiguousarray(rgb, np.uint8)
    npix = img.size // 3
    out = np.empty(4 * npix + 8, np.uint8)
    n = lib.pts_qoi_encode(img.ctypes.data, npix, out.ctypes.data)
    return out[:n].tobytes()


def bcn(data: bytes, n: int, width: int, height: int,
        signed: bool = False) -> np.ndarray:
    """The pixels of a block-compressed DDS image (``data`` from its first
    block; ``n`` 1-7 as PIL numbers BC1-BC7, ``signed`` for BC5S and BC6H
    SF16) as PIL's BcnDecode.c leaves them: [height, width, 4] uint8 R, G,
    B, A (BC5's blue 0, BC5S's 128; BC5's and BC6H's alpha unused), or
    [height, width] for BC4."""
    lib = _build.load_host()
    buf, ptr = _source(data)
    out = np.zeros((height, width) + (() if n == 4 else (4,)), np.uint8)
    if lib.pts_bcn_decode(ptr, buf.size, n, int(signed), width, height,
                          out.ctypes.data):
        raise BrokenData("DDS data ends before the last block")
    return out


def blp_dxt(data: bytes, alpha_encoding: int, alpha: bool, width: int,
            height: int) -> np.ndarray:
    """PIL's block rows of a BLP2 DXT image (``data`` from its first block;
    ``alpha_encoding`` 0 DXT1, 1 DXT3, 7 DXT5; ``alpha`` the header's
    flag) as BlpImagePlugin's Python decoders build them, not as
    BcnDecode.c (``csrc/bcn_decode.cpp`` lists where they differ): [4 *
    block rows, 4 * blocks a row, 3 or 4] uint8, RGB for DXT1 without the
    flag, else RGBA, for the BLP reader to lay out at the image's width."""
    lib = _build.load_host()
    buf, ptr = _source(data)
    bx, by = -(-width // 4), -(-height // 4)
    bands = 3 if alpha_encoding == 0 and not alpha else 4
    out = np.zeros((4 * by, 4 * bx, bands), np.uint8)
    if lib.pts_blp_dxt_decode(ptr, buf.size, alpha_encoding, int(alpha),
                              width, height, out.ctypes.data):
        raise BrokenData("BLP data ends before the last block row")
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
