"""Three formats PIL reads through plugins of their own, without PIL: the
first frame of an Autodesk FLI/FLC animation, the base image of a Kodak
PhotoCD file, and the image of an IPTC/NAA record.

``utils/image.py`` names the format (``_PIL_OPENS``, and here each
plugin's whole ``_open``: ``OPEN_CHECKS``, and ``HEADER_CHECKS`` for the
two plugins without a prefix test) and calls the decoders here
(``DECODERS``); each equals PIL 12.1's ``convert("RGBA")`` bit for bit, as
the JAX package reads a file through ``PIL.Image.open``:

- FLI (``FliImagePlugin``): the 128-byte header (magic 0xAF11 or 0xAF12,
  flags 0 or 3, its reserved fields zero), a frame count of one or more;
  the palette from the first frame's first colour chunk (a prefix chunk
  0xF100 skipped first; chunk 4 at 8 bits, chunk 11 at 6 bits shifted
  left by 2, the low 8 bits kept; packets of a skip and a count, 0 meaning
  256), else a grey ramp; then the frame at byte 128, whatever comes
  first there (a prefix chunk is not a frame: None), as PIL's loader hands
  it to FliDecode.c (``csrc/fli_decode.cpp``: SS2, LC, BLACK, BRUN and
  COPY onto zeros), through the palette, opaque;
- PCD (``PcdImagePlugin``): ``PCD_`` at byte 2,048 and the orientation in
  the low two bits of byte 3,586; the 768x512 base image at byte 196,608,
  in chunks of two luma lines, then 384 Cb and 384 Cr samples both lines
  share, PhotoYCC to RGB by UnpackYCC.c's tables (:data:`_YCC`), turned
  90 degrees (orientation 1) or 270 (orientation 3) with ``expand``;
- IPTC (``IptcImagePlugin``): the fields (a 0x1C marker, a record and a
  dataset number, a 16-bit length, or 128 + n and an n-byte one), up to
  the first (8, 10) field; the mode from (3, 60) (1 and 0: ``L``; 3 or 4
  and a component: ``RGB`` or ``CMYK``, with the band of (3, 65), 1 if
  absent), the size from (3, 20) and (3, 30), the compression from
  (3, 120) (1 raw, 5 "jpeg", any other an error); then every (8, 10)
  field in a row joined: raw data under a ``P5`` header at the size, read
  as a PNM, "jpeg" data opened as any file is (``image._sniff`` and the
  decoders: PIL runs ``Image.open`` on it), its pixels without the
  transparency PIL keeps in the inner image's ``info`` (a PNG's ``tRNS``
  unapplied; a GIF or XPM inside is refused); a band puts an ``L`` image
  into one channel of an otherwise black ``RGB`` or ``CMYK`` image (any
  other mode there is PIL's ``ValueError``: None). The image has the inner
  image's size, as PIL takes the inner image's memory.

Where a plugin's ``_open`` fails in a way ``Image.open`` takes as "not
this format" (a ``SyntaxError``, or an ``IndexError``, ``TypeError``,
``KeyError``, ``EOFError`` or ``struct.error`` that ``ImageFile`` turns
into one; no mode; a size of no pixels), the checks answer False and
``utils/image.py`` goes on to the next plugin as PIL does: an FLI header
with no frame after it, a PCD marker in a file shorter than 3,587 bytes,
an IPTC record without (3, 60). An ``OSError`` of the open (an IPTC
length form above 132, a compression other than 1 or 5) and any failure
of the load are None.

The FLI frame is host C++, its packets being serial; the PCD conversion
and the IPTC fields are host numpy and Python.
"""

from __future__ import annotations

import struct

import numpy as np

from .. import _build
from .rasters import BrokenRaster, _NextPlugin, _opens


def _image():
    """``utils/image.py``, which imports this module at its own load."""
    from . import image
    return image


def _i16(s: bytes, at: int = 0) -> int:
    return struct.unpack_from("<H", s, at)[0]


def _i32(s: bytes, at: int = 0) -> int:
    return struct.unpack_from("<I", s, at)[0]


def _as_next_plugin(open_fn):
    """``open_fn`` with the errors ``ImageFile`` turns into a
    ``SyntaxError`` raised as :class:`_NextPlugin`."""
    def wrapped(data: bytes):
        try:
            return open_fn(data)
        except (IndexError, TypeError, KeyError, EOFError,
                struct.error) as e:
            raise _NextPlugin(f"{type(e).__name__}: {e}") from None
    return wrapped


# ---- FLI --------------------------------------------------------------------

def _fli_accept(s: bytes) -> bool:
    return (len(s) >= 16 and _i16(s, 4) in (0xAF11, 0xAF12)
            and _i16(s, 14) in (0, 3))


def _fli_palette(data: bytes, pos: int, palette: np.ndarray,
                 shift: int) -> None:
    """FliImageFile._palette from ``data[pos]``: packets of a skip and a
    count of RGB triplets (0 meaning 256), each shifted left."""
    i = 0
    count = _i16(data[pos:pos + 2])
    pos += 2
    for _ in range(count):
        s = data[pos:pos + 2]
        pos += len(s)
        i += s[0]
        n = s[1] or 256
        s = data[pos:pos + 3 * n]
        pos += len(s)
        m = len(s) // 3
        if len(s) % 3 or m and i + m > 256:
            raise IndexError("a colour cut short or past entry 255")
        palette[i:i + m] = np.frombuffer(s, np.uint8).reshape(m, 3).astype(
            np.int32) << shift
        i += m


@_as_next_plugin
def fli_open(data: bytes):
    """FliImageFile._open: (width, height, [256, 3] uint8 palette)."""
    s = data[:128]
    if not (_fli_accept(s) and s[20:22] == bytes(2) and s[42:80] == bytes(38)
            and s[88:] == bytes(40)):
        raise _NextPlugin("not an FLI/FLC file")
    n_frames = _i16(s, 6)
    size = _i16(s, 8), _i16(s, 10)
    palette = np.repeat(np.arange(256, dtype=np.int32)[:, None], 3, 1)
    pos = 128
    s = data[pos:pos + 16]
    pos += len(s)
    if _i16(s, 4) == 0xF100:                    # a prefix chunk: skipped
        pos = 128 + _i32(s)
        s = data[pos:pos + 16]
        pos += len(s)
    if _i16(s, 4) == 0xF1FA:                    # the first colour chunk
        chunk_size = None
        for _ in range(_i16(s, 6)):
            if chunk_size is not None:
                pos += chunk_size - 6
            s = data[pos:pos + 6]
            pos += len(s)
            chunk_type = _i16(s, 4)
            if chunk_type in (4, 11):
                _fli_palette(data, pos, palette, 2 if chunk_type == 11 else 0)
                break
            chunk_size = _i32(s)
            if not chunk_size:
                break
    if n_frames < 1:                            # seek(0): _seek_check
        raise EOFError("attempt to seek outside sequence")
    s = data[128:132]
    if not s:
        raise EOFError("missing frame size")
    _i32(s)
    if size[0] <= 0 or size[1] <= 0:
        raise _NextPlugin("no pixels")
    return size[0], size[1], (palette & 255).astype(np.uint8)


def decode_fli(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8: the first frame through its palette."""
    width, height, palette = fli_open(data)
    _image()._check_size(width, height)
    # ImageFile.load reads the frame in blocks of its size, and the
    # decoder waits for the whole frame, or for all but a last odd byte
    framesize, left = _i32(data, 128), len(data) - 128
    if 0 < framesize <= left:
        n = framesize
    elif left % 2 and framesize == left + 1:
        n = left
    else:
        raise BrokenRaster("image file is truncated")
    frame = np.frombuffer(data, np.uint8, n, 128)
    out = np.zeros((height, width), np.uint8)
    if _build.load_host().pts_fli_decode(frame.ctypes.data, n, width, height,
                                         out.ctypes.data):
        raise BrokenRaster("broken FLI frame")
    lut = np.full((256, 4), 255, np.uint8)
    lut[:, :3] = palette
    return lut.view(np.uint32)[out[..., None]].view(np.uint8).reshape(
        height, width, 4)


# ---- PCD --------------------------------------------------------------------

def _ycc_table(scale: float, offset: int = 0,
               weight: float = 1.0) -> np.ndarray:
    """A table of UnpackYCC.c: ``(int)(v + 0.5)`` of
    ``weight * (i - offset) * scale`` (C truncates towards zero)."""
    i = np.arange(256, dtype=np.float64)
    return np.trunc(weight * (i - offset) * scale + 0.5).astype(np.int32)


# PhotoYCC: Y * 1.3584, Cb = (Cb - 156) * 2.2179, Cr = (Cr - 137) * 1.8215;
# R = Y + Cr, G = Y - 0.194 Cb - 0.509 Cr, B = Y + Cb, each table rounded
# on its own and the sums clipped to 0..255
_YCC = {"L": _ycc_table(1.3584), "CB": _ycc_table(2.2179, 156),
        "CR": _ycc_table(1.8215, 137), "GB": _ycc_table(2.2179, 156, -0.194),
        "GR": _ycc_table(1.8215, 137, -0.509)}
_PCD_BASE = 96 * 2048                     # the 768x512 image's offset
_PCD_CHUNK = 3 * 768                      # two luma lines and their chroma


def ycc_rgb(y, cb, cr) -> np.ndarray:
    """[..., 3] uint8 of PhotoYCC samples as ImagingUnpackYCC converts
    them (rawmode ``YCC;P``)."""
    lum = _YCC["L"][y]
    rgb = np.stack([lum + _YCC["CR"][cr],
                    lum + _YCC["GR"][cr] + _YCC["GB"][cb],
                    lum + _YCC["CB"][cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


@_as_next_plugin
def pcd_open(data: bytes) -> int:
    """PcdImageFile._open: the orientation (0-3)."""
    s = data[2048:2048 + 1539]
    if not s.startswith(b"PCD_"):
        raise _NextPlugin("not a PCD file")
    return s[1538] & 3


def decode_pcd(data: bytes) -> np.ndarray:
    """[512, 768, 4] uint8 (or [768, 512, 4] at orientation 1 or 3)."""
    orientation = pcd_open(data)
    if len(data) < _PCD_BASE + 256 * _PCD_CHUNK:
        raise BrokenRaster("image file is truncated")
    chunks = np.frombuffer(data, np.uint8, 256 * _PCD_CHUNK,
                           _PCD_BASE).reshape(256, _PCD_CHUNK)
    luma = chunks[:, :2 * 768].reshape(512, 768)
    half = np.arange(768) // 2
    cb = np.repeat(chunks[:, 2 * 768 + half], 2, 0)
    cr = np.repeat(chunks[:, 2 * 768 + 384 + half], 2, 0)
    rgba = np.full((512, 768, 4), 255, np.uint8)
    rgba[..., :3] = ycc_rgb(luma, cb, cr)
    if orientation in (1, 3):             # rotate(90 or 270, expand=True)
        rgba = np.ascontiguousarray(np.rot90(rgba, 1 if orientation == 1
                                             else 3))
    return rgba


# ---- IPTC -------------------------------------------------------------------

_IPTC_RECORDS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 240)
_IPTC_COMPRESSION = {1: "raw", 5: "jpeg"}


def _iptc_field(data: bytes, pos: int):
    """IptcImageFile.field at ``data[pos]``: (tag or None, size, the
    position after the field's header)."""
    s = data[pos:pos + 5]
    pos += len(s)
    if not s.strip(b"\x00"):
        return None, 0, pos
    tag = s[1], s[2]
    if s[0] != 0x1C or tag[0] not in _IPTC_RECORDS:
        raise _NextPlugin("invalid IPTC/NAA file")
    size = s[3]
    if size > 132:
        raise BrokenRaster("illegal field length in IPTC/NAA file")
    if size == 128:
        size = 0
    elif size > 128:
        c = data[pos:pos + size - 128]
        pos += len(c)
        size = _iptc_int(c)
    else:
        size = struct.unpack_from(">H", s, 3)[0]
    return tag, size, pos


def _iptc_int(c) -> int:
    """IptcImagePlugin._i: the last 4 bytes, big-endian, zeros before."""
    return struct.unpack(">I", (b"\0\0\0\0" + c)[-4:])[0]


@_as_next_plugin
def iptc_open(data: bytes):
    """IptcImageFile._open: (mode, size, band or None, compression, the
    offset of the first (8, 10) field or None)."""
    info = {}
    pos = 0
    while True:
        offset = pos
        tag, size, pos = _iptc_field(data, pos)
        if not tag or tag == (8, 10):
            break
        tagdata = None
        if size:
            tagdata = data[pos:pos + size]
            pos += len(tagdata)
        if tag in info:
            if isinstance(info[tag], list):
                info[tag].append(tagdata)
            else:
                info[tag] = [info[tag], tagdata]
        else:
            info[tag] = tagdata
    layers, component = info[(3, 60)][0], info[(3, 60)][1]
    mode, band = "", None
    if layers == 1 and not component:
        mode = "L"
    else:
        if layers == 3 and component:
            mode = "RGB"
        elif layers == 4 and component:
            mode = "CMYK"
        band = info[(3, 65)][0] - 1 if (3, 65) in info else 0
    size = _iptc_int(info[(3, 20)]), _iptc_int(info[(3, 30)])
    try:
        compression = _IPTC_COMPRESSION[_iptc_int(info[(3, 120)])]
    except KeyError:
        raise BrokenRaster("Unknown IPTC image compression") from None
    if not mode or size[0] <= 0 or size[1] <= 0:
        raise _NextPlugin("not identified by this driver")
    return mode, size, band, compression, offset if tag == (8, 10) else None


def _png_mode(data: bytes) -> str:
    """PngImagePlugin's mode of an IHDR's colour type and depth."""
    colour, depth = data[25], data[24]
    if colour == 0:
        return {1: "1", 16: "I;16"}.get(depth, "L")
    return {2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}.get(colour, "")


def _jpeg_mode(data: bytes) -> str:
    """JpegImagePlugin's mode: the first frame header's component count
    (1 ``L``, 3 ``RGB``, 4 ``CMYK``), "" where none is found."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return ""
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
        elif 0xD0 <= marker <= 0xD7 or marker == 0x01:
            pos += 2
        elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return {1: "L", 3: "RGB", 4: "CMYK"}.get(
                data[pos + 9] if pos + 9 < len(data) else 0, "")
        else:
            pos += 2 + struct.unpack_from(">H", data, pos + 2)[0]
    return ""


_INNER_MODES = {"PNG": _png_mode, "JPEG": _jpeg_mode}


def _inner_rgba(kind: str, inner: bytes) -> np.ndarray:
    """[H, W, 4] uint8 of the image inside, as the IPTC image takes it."""
    im = _image()
    if kind in ("GIF", "XPM"):
        raise NotImplementedError(
            f"an embedded {kind} image (its transparency, which the IPTC "
            "image drops, is not separated from its pixels)")
    if kind not in im._DECODERS:
        raise NotImplementedError(f"an embedded {kind} image")
    try:
        if kind == "PNG":
            return im._decode_png(inner, transparency=False)
        return im._DECODERS[kind](inner)
    except (im._Refused, NotImplementedError) as e:
        raise NotImplementedError(f"an embedded {kind} image: {e}") from None


def decode_iptc(data: bytes) -> np.ndarray:
    mode, size, band, compression, offset = iptc_open(data)
    im = _image()
    im._check_size(*size)
    if offset is None:
        raise BrokenRaster("cannot load this image")
    parts = []
    pos = offset
    try:
        while True:
            tag, n, pos = _iptc_field(data, pos)
            if tag != (8, 10):
                break
            parts.append(data[pos:pos + n])
            pos += len(parts[-1])
    except (_NextPlugin, struct.error, IndexError) as e:
        raise BrokenRaster(f"IPTC field: {e}") from None
    inner = b"".join(parts)
    if compression == "raw":
        inner = b"P5\n%d %d\n255\n" % size + inner
    kind = im._sniff(inner)
    if kind is None or kind in im._NO_DECODER:
        raise BrokenRaster("cannot identify the embedded image")
    if band is None:
        return _inner_rgba(kind, inner)
    nbands = len(mode)
    if not -nbands <= band < nbands:
        raise BrokenRaster("band past the mode's bands")
    if compression == "raw":
        inner_mode = "L"
    elif kind in _INNER_MODES:
        inner_mode = _INNER_MODES[kind](inner)
    else:
        raise NotImplementedError(f"a band of an embedded {kind} image")
    rgba = _inner_rgba(kind, inner)
    if inner_mode != "L":
        # Image.merge: another mode than L outside band 0 is its "mode
        # mismatch", and ImagingMerge refuses an image of more bands; it
        # copies the bytes of another single-band mode into band 0
        if band % nbands or inner_mode in ("LA", "RGB", "RGBA", "CMYK"):
            raise BrokenRaster("Image.merge refuses the band's mode")
        raise NotImplementedError(
            f"band 0 of an embedded {kind} image of mode {inner_mode!r}")
    planes = np.zeros(rgba.shape[:2] + (nbands,), np.uint8)
    planes[..., band] = rgba[..., 0]
    if mode == "CMYK":
        from . import jpeg
        return jpeg.inverted_cmyk_rgba(255 - planes)
    out = np.full(rgba.shape[:2] + (4,), 255, np.uint8)
    out[..., :3] = planes
    return out


HEADER_CHECKS = {"IPTC": _opens(iptc_open), "PCD": _opens(pcd_open)}
OPEN_CHECKS = {"FLI": _opens(fli_open)}
DECODERS = {"FLI": decode_fli, "PCD": decode_pcd, "IPTC": decode_iptc}
