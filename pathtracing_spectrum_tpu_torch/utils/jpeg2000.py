"""JPEG 2000 for the port's textures and image writer: the bindings of the
host library's decoder ``csrc/j2k_decode.cpp`` and encoder
``csrc/j2k_encode.cpp`` (their shared tables and transform:
``csrc/j2k_common.h``), and the JP2 boxes around the codestream.

The encoder computes what OpenJPEG 2.5.4 computes for the parameters
PIL 12.1's ``Image.save`` passes it at its defaults, so :func:`encode` is
PIL's file byte for byte: one tile, the reversible 5/3 transform at 5
levels (fewer for a side under 32 pixels), 64x64 code-blocks, one
lossless layer in LRCP order, OpenJPEG's comment. A ``"jp2"`` file puts
the codestream behind the signature, ``ftyp``, ``jp2h`` (``ihdr`` and
``colr``) and ``jp2c`` boxes OpenJPEG writes; a ``"j2k"`` file is the bare
codestream (PIL writes it for a name ending in ``.j2k``).

The decoder computes what OpenJPEG gives PIL for every file PIL writes
from L, LA, RGB and RGBA under its save options but the cinema profiles:
the reversible 5/3 and the irreversible 9/7 transform (its float
dequantisation, lifting and ICT rounded as OpenJPEG rounds them), quality
layers (the passes of every layer accumulated, passes a layer cuts
reconstructed at the half step), the five progression orders, precincts,
any code-block size, tiles with image and tile offsets (each tile's
transform in the phase of its odd or even origin), RCT, signed samples
and PLT markers, so :func:`decode_rgba` equals the JAX package's
``convert("RGBA")`` bit for bit. ``csrc/j2k_decode.cpp`` names where
OpenJPEG departs from the standard and the decoder follows it. Other
flavours (tile-parts, code-block styles, SOP and EPH markers, COC, QCC,
RGN, POC, PPM and PPT markers, samples of other than 8 bits, subsampled
components, ...) raise ``NotImplementedError`` naming the flavour. The
header checks are PIL's own (``Jpeg2KImagePlugin._open``), then
OpenJPEG's strict reading: a file cut anywhere is broken, apart from a
cut just after a tile's SOT marker code, which OpenJPEG gives PIL with
the tiles before it decoded and zeros after; a marker code OpenJPEG does
not know in the main header is skipped two bytes at a time to the next
one it knows (``opj_j2k_read_unk``).

Both are host C++ (tier-1 is bit-serial), with no Python fallback: when
the host library cannot be built, the call raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import io
import struct

import numpy as np

from .. import _build


class BrokenJpeg2000(ValueError):
    """The file is a JPEG 2000 file, but broken (PIL or OpenJPEG fails on
    it)."""


_CODESTREAM = b"\xff\x4f\xff\x51"
_SIGNATURE = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"
# colr enumerated colour spaces: sRGB, grey
_SRGB, _GREY = 16, 17


def _codestream(pixels: np.ndarray) -> bytes:
    img = np.ascontiguousarray(pixels, np.uint8)
    h, w = img.shape[:2]
    lib = _build.load_host()
    handle = lib.pts_j2k_encode(img.ctypes.data, w, h,
                                1 if img.ndim == 2 else img.shape[2])
    if not handle:
        raise MemoryError("JPEG 2000 encoder: out of memory")
    try:
        data = np.empty(lib.pts_buffer_size(handle), np.uint8)
        lib.pts_buffer_copy(handle, data.ctypes.data)
    finally:
        lib.pts_buffer_free(handle)
    return data.tobytes()


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def encode(pixels: np.ndarray, kind: str) -> bytes:
    """The JPEG 2000 file PIL's ``Image.save`` writes for uint8 ``pixels``
    ([H, W] grey or [H, W, 3] RGB, row 0 = image top): the codestream for
    ``kind`` ``"j2k"``, else (``"jp2"``) the JP2 file."""
    h, w = pixels.shape[:2]
    if h == 0 or w == 0:
        raise SystemError("tile cannot extend outside image")
    stream = _codestream(pixels)
    if kind == "j2k":
        return stream
    nc = 1 if pixels.ndim == 2 else pixels.shape[2]
    ihdr = _box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, 7, 7, 0, 0))
    colr = _box(b"colr", struct.pack(">BBBI", 1, 0, 0,
                                     _GREY if nc == 1 else _SRGB))
    return (_SIGNATURE + _box(b"ftyp", b"jp2 \0\0\0\0jp2 ")
            + _box(b"jp2h", ihdr + colr) + _box(b"jp2c", stream))


# ---- reading ---------------------------------------------------------------

class _BoxReader:
    """Jpeg2KImagePlugin.BoxReader: its reads and checks, whose failures
    are PIL's (SyntaxError, OSError: the file does not open)."""

    def __init__(self, fp, length: int = -1):
        self.fp, self.length = fp, length
        self.remaining = -1

    def _can_read(self, n: int) -> bool:
        if self.length >= 0 and self.fp.tell() + n > self.length:
            return False
        return n <= self.remaining if self.remaining >= 0 else True

    def _take(self, n: int) -> bytes:
        if not self._can_read(n):
            raise BrokenJpeg2000("Not enough data in header")
        data = self.fp.read(n)
        if len(data) < n:
            raise BrokenJpeg2000(f"Expected to read {n} bytes")
        if self.remaining > 0:
            self.remaining -= n
        return data

    def read(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))

    def read_boxes(self) -> "_BoxReader":
        n = self.remaining
        return _BoxReader(io.BytesIO(self._take(n)), n)

    def has_next_box(self) -> bool:
        if self.length >= 0:
            return self.fp.tell() + self.remaining < self.length
        return True

    def next_box_type(self) -> bytes:
        if self.remaining > 0:
            self.fp.seek(self.remaining, io.SEEK_CUR)
        self.remaining = -1
        lbox, tbox = self.read(">I4s")
        hlen = 8
        if lbox == 1:
            lbox, hlen = self.read(">Q")[0], 16
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise BrokenJpeg2000("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _jp2_header(data: bytes) -> "tuple[int, int, int, dict]":
    """_parse_jp2_header's size and component count (PIL's mode) and the
    ``jp2h`` boxes OpenJPEG reads after it: (width, height, components,
    {box type: body}). One component of more than 8 bits (PIL's mode
    ``I;16``) is refused."""
    fp = io.BytesIO(data)
    fp.seek(12)
    reader = _BoxReader(fp)
    while reader.has_next_box():
        tbox = reader.next_box_type()
        if tbox == b"jp2h":
            header = reader.read_boxes()
            break
        if tbox == b"ftyp":
            reader.read(">4s")
    boxes, size, nc = {}, None, None
    while header.has_next_box():
        tbox = header.next_box_type()
        start = header.fp.tell()
        body = header.fp.getvalue()[start:start + header.remaining]
        boxes.setdefault(tbox, body)
        if tbox == b"ihdr":
            height, width, nc, bpc = header.read(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                raise NotImplementedError(
                    f"a JP2 header of {(bpc & 0x7F) + 1}-bit grey samples")
        elif tbox == b"colr" and nc == 4:
            header.read(">BBBI")
        elif tbox == b"res ":
            res = header.read_boxes()
            while res.has_next_box():
                if res.next_box_type() == b"resc":
                    res.read(">HHHHBB")
                    break
    if size is None or nc not in (1, 2, 3, 4):
        raise BrokenJpeg2000("Malformed JP2 header")
    return size[0], size[1], nc, boxes


def _jp2_codestream(data: bytes) -> bytes:
    """OpenJPEG's walk of the top-level boxes to ``jp2c``: ``ftyp`` second
    (after the signature the sniff matched), its compatibility list whole
    4-byte entries, ``jp2h`` before ``jp2c``; the codestream is the rest
    of the file."""
    pos, seen = 12, []
    while True:
        if pos + 8 > len(data):
            raise BrokenJpeg2000("no codestream box")
        lbox, tbox = struct.unpack_from(">I4s", data, pos)
        hlen = 8
        if lbox == 1:
            if pos + 16 > len(data):
                raise BrokenJpeg2000("Stream too short")
            lbox, hlen = struct.unpack_from(">Q", data, pos + 8)[0], 16
        if not seen and tbox != b"ftyp":
            raise BrokenJpeg2000("second box must be file type box")
        if tbox == b"jp2c":
            if b"jp2h" not in seen:
                raise BrokenJpeg2000("bad placed jpeg codestream")
            return data[pos + hlen:]
        if lbox == 0 or lbox < hlen or pos + lbox > len(data):
            raise BrokenJpeg2000(f"Invalid box size for box {tbox!r}")
        if tbox == b"ftyp" and (lbox - hlen < 8 or (lbox - hlen - 8) % 4):
            raise BrokenJpeg2000("Error with FTYP signature Box size")
        seen.append(tbox)
        pos += lbox


def _check_jp2_colour(nc: int, boxes: dict) -> None:
    """The colour boxes whose meaning is PIL's mode as it stands: ``colr``
    sRGB for 3 or 4 components, grey for 1 or 2 (or none), and a
    ``cdef`` that leaves the channels in order."""
    if b"colr" in boxes:
        colr = boxes[b"colr"]
        if len(colr) < 3:
            raise BrokenJpeg2000("bad colr box")
        if colr[0] != 1 or len(colr) < 7:
            raise NotImplementedError("a colr box with an ICC profile")
        enumcs = struct.unpack_from(">I", colr, 3)[0]
        if enumcs != (_GREY if nc <= 2 else _SRGB):
            raise NotImplementedError(
                f"colour space {enumcs} with {nc} components")
    for kind in (b"pclr", b"cmap", b"bpcc"):
        if kind in boxes:
            raise NotImplementedError(f"a {kind.decode()} box")
    if b"cdef" in boxes:
        cdef = boxes[b"cdef"]
        n = struct.unpack_from(">H", cdef)[0] if len(cdef) >= 2 else -1
        if n != nc or len(cdef) < 2 + 6 * n:
            raise NotImplementedError("a cdef box not naming each channel")
        for i in range(n):
            cn, _, asoc = struct.unpack_from(">HHH", cdef, 2 + 6 * i)
            if cn != i or asoc not in (0, 65535, i + 1):
                raise NotImplementedError("a cdef box that reorders channels")


def _siz(stream: bytes) -> "tuple[int, int, int]":
    """_parse_codestream: the size and component count of the SIZ segment
    after the SOC and SIZ marker codes."""
    fp = io.BytesIO(stream[4:])
    hdr = fp.read(2)
    if len(hdr) < 2:
        raise BrokenJpeg2000("truncated SIZ")
    lsiz = hdr[0] << 8 | hdr[1]
    siz = hdr + fp.read(lsiz - 2)
    try:
        _, _, xsiz, ysiz, xo, yo, _, _, _, _, csiz = struct.unpack_from(
            ">HHIIIIIIIIH", siz)
    except struct.error:
        raise BrokenJpeg2000("truncated SIZ") from None
    if csiz not in (1, 2, 3, 4):
        raise BrokenJpeg2000("unable to determine J2K image mode")
    return xsiz - xo, ysiz - yo, csiz


def header(data: bytes) -> "tuple[int, int]":
    """(width, height) as PIL's ``Image.open`` reads them (the ihdr box of
    a JP2 file, the SIZ segment of a codestream)."""
    if data.startswith(_CODESTREAM):
        return _siz(data)[:2]
    return _jp2_header(data)[:2]


def decode_rgba(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a JPEG 2000 file's bytes (a JP2 file or a
    codestream), row 0 = image top: PIL's ``convert("RGBA")`` of L, LA,
    RGB or RGBA samples. Raises :class:`BrokenJpeg2000` where PIL fails
    and ``NotImplementedError`` naming a flavour not decoded here."""
    if data.startswith(_CODESTREAM):
        _, _, nc = _siz(data)
        stream = data
    else:
        w, h, nc, boxes = _jp2_header(data)
        stream = _jp2_codestream(data)
        _check_jp2_colour(nc, boxes)
    samples = _decode_codestream(stream)
    if samples.shape[2] != nc:
        raise NotImplementedError("a JP2 header whose component count is "
                                  "not the codestream's")
    if not data.startswith(_CODESTREAM) and samples.shape[:2] != (h, w):
        raise NotImplementedError("a JP2 header whose size is not the "
                                  "codestream's")
    out = np.empty(samples.shape[:2] + (4,), np.uint8)
    grey = nc <= 2
    out[..., :3] = samples[..., :1] if grey else samples[..., :3]
    out[..., 3] = samples[..., nc - 1] if nc in (2, 4) else 255
    return out


def _decode_codestream(stream: bytes) -> np.ndarray:
    lib = _build.load_host()
    buf = np.frombuffer(stream, np.uint8)
    status = ctypes.c_int32(0)
    msg = ctypes.create_string_buffer(256)
    handle = lib.pts_j2k_decode(buf.ctypes.data, buf.size,
                                ctypes.byref(status), msg, len(msg))
    if not handle:
        text = msg.value.decode(errors="replace")
        if status.value == 2:
            raise NotImplementedError(text)
        raise BrokenJpeg2000(text)
    try:
        w, h, nc = ctypes.c_int32(0), ctypes.c_int32(0), ctypes.c_int32(0)
        lib.pts_j2k_size(handle, ctypes.byref(w), ctypes.byref(h),
                         ctypes.byref(nc))
        out = np.empty((h.value, w.value, nc.value), np.uint8)
        lib.pts_j2k_copy(handle, out.ctypes.data)
    finally:
        lib.pts_j2k_free(handle)
    return out
