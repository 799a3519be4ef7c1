"""Host texture loading without PIL, and the reference's nearest sampling.

Port of ``pathtracing_spectrum_tpu/utils/image.py``. The JAX package
decodes with PIL; the port must not import it (the machine with the card
has none), so :func:`load_rgba` decodes each format itself. It chooses
the decoder by the file's leading bytes, as PIL does, never by its
extension, and its output equals PIL's ``convert("RGBA")`` divided by
255, bit for bit:

- PNG, with the standard library's ``zlib`` and the five row filters in
  numpy: colour types 0 (grey, 1/2/4/8/16 bits), 2 (RGB), 3 (palette,
  1/2/4/8 bits), 4 (grey + alpha) and 6 (RGBA), 8 or 16 bits, plain or
  Adam7-interlaced; ``tRNS`` as PIL applies it; 16-bit samples keep their
  high byte, as PIL does for colour types 2, 4 and 6;
- JPEG through the host library's decoder (``utils/jpeg.py``,
  ``csrc/jpeg_decode.cpp``): baseline, extended and progressive Huffman
  frames with 8-bit samples, grey, YCbCr or RGB, any integral sampling
  factors, restart intervals, with libjpeg-turbo's arithmetic;
- BMP: ``BI_RGB`` at 1, 4, 8, 16, 24 and 32 bits (the fourth byte of a
  32-bit pixel ignored, as PIL ignores it) and ``BI_BITFIELDS`` at 16, 24
  and 32 bits with the masks PIL reads, bottom-up or top-down;
- TGA: image types 1, 2, 3, 9, 10 and 11 (colour-mapped, true-colour,
  grey, and their run-length forms) at 8, 24 and 32 bits, with the origin
  bits;
- binary PNM: P5 and P6 with maxval 255.

One named deviation from PIL: a 16-bit grey PNG (colour type 0) keeps the
high byte of each sample, as stb_image (the reference's loader) and PIL's
own 16-bit RGB path do, and its ``tRNS`` key is compared with the 16-bit
sample. PIL opens it as mode ``I;16`` and ``convert("RGBA")`` clips it at
255 instead, so in the JAX package a 16-bit roughness map comes out
almost all 1.0.

A missing or broken file of a format decoded here (no such path, a bad
checksum, truncated data, a header PIL refuses) returns ``None``, as PIL's
exception does in the JAX package and as the reference's ``Image`` fails
soft to black (image.cpp:48-49). A format or flavour not decoded here
(GIF, TIFF, WebP, PSD, CMYK/YCCK, 12-bit, arithmetic-coded and lossless
JPEG, RLE BMP, 16-bit PNM, ...) raises ``NotImplementedError`` naming the
file and the format: a texture is never dropped quietly.

Sampling on the device is ``ops/texturing.py``; :func:`sample_nearest` is
the host ``tex2D`` for tests and tools. :func:`write_png` is the writer the
viewer and the CLI save through (8-bit grey or RGB; the JAX package saves
through PIL).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import jpeg

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, allowed bit depths)
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# leading bytes of formats the port does not decode, to name them
_OTHER_FORMATS = ((b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
                  (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                  (b"8BPS", "PSD"), (b"\x00\x00\x01\x00", "ICO"))


class _Unreadable(Exception):
    """The file is of a format decoded here, but broken: fail soft like
    the reference (PIL raises on it)."""


class _Refused(Exception):
    """A flavour of a format decoded here that this decoder does not
    take."""


def load_rgba(path: str) -> "np.ndarray | None":
    """Load an image file as float32 RGBA [H, W, 4] in [0, 1] (row 0 =
    image top), equal to PIL's ``convert("RGBA")`` / 255 (see the module
    docstring for the formats and the one deviation). ``None`` when the
    file is missing or broken; ``NotImplementedError`` naming the file and
    the format for a format or flavour not decoded here."""
    rgba = load_rgba8(path)
    return None if rgba is None else rgba.astype(np.float32) / 255.0


def load_rgba8(path: str) -> "np.ndarray | None":
    """:func:`load_rgba` as uint8 [H, W, 4]: PIL's ``convert("RGBA")``
    itself."""
    if not path:
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if not data:
        return None
    kind = _sniff(data)
    if kind is None:
        raise NotImplementedError(
            f"{path}: {_other_format(data) or 'an image format'} is not "
            "decoded by the PyTorch port (PNG, JPEG, BMP, TGA and binary "
            "PNM are; convert it; ROADMAP Queue 1 item 11)")
    try:
        return _DECODERS[kind](data)
    except (_Refused, NotImplementedError) as e:
        raise NotImplementedError(
            f"{path}: {kind} ({e}) is not decoded by the PyTorch port "
            "(ROADMAP Queue 1 item 11)") from None
    except (_Unreadable, jpeg.BrokenJpeg, zlib.error, struct.error,
            ValueError, IndexError):
        return None


def _sniff(data: bytes) -> "str | None":
    """The format PIL would open the file as, among those decoded here
    (PIL tries BMP, JPEG, PNM and PNG by their leading bytes, and TGA,
    which has none, only after every other format)."""
    if data.startswith(b"BM"):
        return "BMP"
    if data.startswith(b"\xff\xd8\xff"):
        return "JPEG"
    if len(data) >= 2 and data[:1] == b"P" and data[1] in b"0123456fy":
        return "PNM"
    if data.startswith(_SIGNATURE):
        return "PNG"
    if _other_format(data):
        return None
    # TgaImagePlugin's header check
    if len(data) >= 18 and data[1] in (0, 1) and data[16] in (1, 8, 16, 24,
                                                              32):
        w, h = struct.unpack_from("<HH", data, 12)
        if w > 0 and h > 0:
            return "TGA"
    return None


def _other_format(data: bytes) -> "str | None":
    """The name of a format not decoded here, by its leading bytes."""
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    return next((n for m, n in _OTHER_FORMATS if data.startswith(m)), None)


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise _Unreadable("truncated chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise _Unreadable(f"bad CRC in {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise _Unreadable("no IEND chunk")


# Adam7: (x start, y start, x step, y step) of each of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _decode_png(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a PNG file's bytes."""
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = body
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise _Unreadable("no IHDR chunk")
    width, height, depth, colour, _, filt, interlace = header
    if colour not in _COLOUR_TYPES or depth not in _COLOUR_TYPES[colour][1]:
        raise _Unreadable(f"colour type {colour} with bit depth {depth}")
    if filt != 0 or interlace > 1 or width == 0 or height == 0:
        raise _Unreadable("bad header")
    if colour == 3 and palette is None:
        raise _Unreadable("palette image without PLTE")
    spp = _COLOUR_TYPES[colour][0]
    raw = zlib.decompress(b"".join(idat))
    if not interlace:
        samples, _ = _pass_samples(raw, 0, width, height, spp, depth)
    else:
        samples = np.zeros((height, width, spp),
                           np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if w > 0 and h > 0:         # an empty pass has no filter bytes
                sub, pos = _pass_samples(raw, pos, w, h, spp, depth)
                samples[y0::dy, x0::dx] = sub
    return _to_rgba(samples, colour, depth, palette, trns)


def _pass_samples(raw: bytes, pos: int, width: int, height: int, spp: int,
                  depth: int):
    """[H, W, spp] samples (uint16 at 16 bits) of the filtered rows of one
    image or Adam7 pass starting at ``raw[pos]``, and where it ends."""
    bits = spp * depth
    stride = (width * bits + 7) // 8
    end = pos + height * (stride + 1)
    if len(raw) < end:
        raise _Unreadable("truncated image data")
    rows = _unfilter(raw[pos:end], height, stride, max(1, bits // 8))
    if depth < 8:
        samples = _unpack(rows, depth, width)[..., None]
    elif depth == 16:
        samples = rows.view(">u2").astype(np.uint16)
    else:
        samples = rows
    return samples.reshape(height, width, spp), end


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        kind = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = np.frombuffer(_unfilter_sequential(
                kind, line.tobytes(), prev.tobytes(), bpp), np.uint8)
        else:
            raise _Unreadable(f"filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_sequential(kind: int, line: bytes, prev: bytes,
                         bpp: int) -> bytearray:
    """Average (3) and Paeth (4): each byte depends on the one ``bpp``
    to its left, so they run byte by byte."""
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def _unpack(rows: np.ndarray, depth: int, width: int) -> np.ndarray:
    """Sub-byte samples (1, 2 or 4 bits, most significant first)."""
    bits = np.unpackbits(rows, axis=1)
    bits = bits[:, :width * depth].reshape(rows.shape[0], width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2).astype(np.uint8)


def _to_rgba(samples: np.ndarray, colour: int, depth: int, palette,
             trns) -> np.ndarray:
    """RGBA8 of [H, W, spp] samples as PIL's ``convert("RGBA")`` makes it.
    16-bit samples keep their high byte, as PIL does for colour types 2, 4
    and 6 and stb_image for all; for 16-bit grey (type 0) PIL clips the
    value at 255 instead, and the port deviates from it (see the module
    docstring)."""
    h, w = samples.shape[:2]
    wide = samples
    if depth == 16:
        samples = (samples >> 8).astype(np.uint8)
    out = np.full((h, w, 4), 255, np.uint8)
    if colour == 3:
        n_pal = len(palette) // 3
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        pal[:n_pal, :3] = np.frombuffer(palette, np.uint8,
                                        n_pal * 3).reshape(n_pal, 3)
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            pal[:len(alpha), 3] = alpha
        return pal[samples[..., 0]]
    if colour in (0, 4):
        grey = samples[..., 0]
        if depth < 8:
            grey = (grey * (255 // ((1 << depth) - 1))).astype(np.uint8)
        out[..., :3] = grey[..., None]
        if colour == 4:
            out[..., 3] = samples[..., 1]
        elif trns is not None and len(trns) >= 2:
            # PIL compares the 8-bit grey with the chunk's raw value (a
            # 1-bit image's as 0 or 255); at 16 bits the port compares the
            # 16-bit sample, as stb_image does
            key = struct.unpack(">H", trns[:2])[0]
            if depth == 1:
                key = 255 if key else 0
            value = (wide[..., 0] if depth == 16 else grey).astype(np.int32)
            out[..., 3] = np.where(value == key, 0, 255)
        return out
    out[..., :3] = samples[..., :3]
    if colour == 6:
        out[..., 3] = samples[..., 3]
    elif trns is not None and len(trns) >= 6:
        # PIL compares the 8-bit samples (at 16 bits, the high bytes) with
        # the chunk's raw 16-bit values
        # (in int32: the keys may exceed 255)
        key = np.array(struct.unpack(">HHH", trns[:6]), np.int32)
        match = (samples[..., :3].astype(np.int32) == key).all(-1)
        out[..., 3] = np.where(match, 0, 255)
    return out


# ---- BMP, TGA, PNM: PIL's BmpImagePlugin, TgaImagePlugin, PpmImagePlugin

def _u16(data: bytes, pos: int) -> int:
    return struct.unpack_from("<H", data, pos)[0]


def _u32(data: bytes, pos: int) -> int:
    return struct.unpack_from("<I", data, pos)[0]


def _rows(data: bytes, pos: int, height: int, nbytes: int,
          stride: int) -> np.ndarray:
    """[height, nbytes] uint8: ``height`` rows of ``nbytes`` bytes each,
    ``stride`` apart from ``data[pos]``, as stored."""
    if pos + (height - 1) * stride + nbytes > len(data):
        raise _Unreadable("truncated pixel data")
    buf = np.frombuffer(data, np.uint8, (height - 1) * stride + nbytes, pos)
    return np.lib.stride_tricks.as_strided(
        buf, (height, nbytes), (stride, 1)).copy()


def _rgb15(pix: np.ndarray, green_bits: int) -> np.ndarray:
    """PIL's BGR;15 (5-5-5) and BGR;16 (5-6-5) unpackers: [.., 3] RGB8 of
    little-endian 16-bit pixels."""
    pix = pix.astype(np.int64)
    gmax = (1 << green_bits) - 1
    b = (pix & 31) * 255 // 31
    g = ((pix >> 5) & gmax) * 255 // gmax
    r = ((pix >> (5 + green_bits)) & 31) * 255 // 31
    return np.stack([r, g, b], -1).astype(np.uint8)


# 32-bit BI_BITFIELDS masks PIL reads (r, g, b, a) -> byte order of R, G, B
# and A in the pixel (-1: no alpha)
_BMP_MASKS32 = {
    (0xFF0000, 0xFF00, 0xFF, 0): (2, 1, 0, -1),                 # BGRX
    (0xFF000000, 0xFF0000, 0xFF00, 0): (3, 2, 1, -1),           # XBGR
    (0xFF000000, 0xFF00, 0xFF, 0): (3, 1, 0, -1),               # BGXR
    (0xFF000000, 0xFF0000, 0xFF00, 0xFF): (3, 2, 1, 0),         # ABGR
    (0xFF, 0xFF00, 0xFF0000, 0xFF000000): (0, 1, 2, 3),         # RGBA
    (0xFF0000, 0xFF00, 0xFF, 0xFF000000): (2, 1, 0, 3),         # BGRA
    (0xFF000000, 0xFF00, 0xFF, 0xFF0000): (3, 1, 0, 2),         # BGAR
    (0, 0, 0, 0): (2, 1, 0, 3),                                 # BGRA
}


def _decode_bmp(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a BMP file, as BmpImagePlugin reads it."""
    offset, hsize = _u32(data, 10), _u32(data, 14)
    head = data[18:14 + hsize]
    if len(head) != hsize - 4:
        raise _Unreadable("truncated header")
    pos = 14 + hsize              # where the palette (or the masks) start
    masks = None
    if hsize == 12:               # OS/2 BITMAPCOREHEADER
        width, height, bits = _u16(head, 0), _u16(head, 2), _u16(head, 6)
        compression, colors, pad, top_down = 0, 0, 3, False
    elif hsize in (40, 52, 56, 64, 108, 124):
        top_down = head[7] == 0xFF
        width = _u32(head, 0)
        height = (1 << 32) - _u32(head, 4) if top_down else _u32(head, 4)
        bits, compression = _u16(head, 10), _u32(head, 12)
        colors, pad = _u32(head, 28), 4
        if compression == 3:
            if len(head) >= 48:
                masks = struct.unpack_from("<III", head, 36) + (
                    (_u32(head, 48),) if len(head) >= 52 else (0,))
            else:                 # 40-byte header: three masks follow it
                masks = struct.unpack_from("<III", data, pos) + (0,)
                pos += 12
    else:
        raise _Unreadable(f"BMP header size {hsize}")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise _Unreadable(f"{bits}-bit BMP")
    if compression in (1, 2):
        raise _Refused(f"run-length compression {compression}")
    if compression not in (0, 3):
        raise _Unreadable(f"BMP compression {compression}")
    if width == 0 or height == 0:
        raise _Unreadable("empty BMP")
    stride = ((width * bits + 31) >> 3) & ~3
    rows = _rows(data, offset, height, (width * bits + 7) // 8, stride)
    if not top_down:
        rows = rows[::-1]
    out = np.full((height, width, 4), 255, np.uint8)
    if bits <= 8:
        if compression != 0:
            raise _Unreadable("bitfields on a palette BMP")
        if not 0 < colors <= 65536:
            raise _Unreadable(f"BMP palette size {colors}")
        palette = data[pos:pos + pad * colors]
        index = (_unpack(rows, bits, width) if bits < 8
                 else rows[:, :width])
        grey_values = (0, 255) if colors == 2 else range(colors)
        if all(palette[i * pad:i * pad + 3] == bytes([v]) * 3
               for i, v in enumerate(grey_values)):
            # PIL drops a grey palette and reads the samples as mode "1"
            # or "L": the same values where the samples are 1 or 8 bits
            if (colors == 2) != (bits == 1) or (colors != 2 and bits != 8):
                raise _Refused(f"a {bits}-bit BMP with a {colors}-entry "
                               "grey palette")
            out[..., :3] = (index * 255 if bits == 1 else index)[..., None]
            return out
        n = min(len(palette) // pad, 256)
        lut = np.zeros((256, 3), np.uint8)
        lut[:n] = np.frombuffer(palette, np.uint8, n * pad).reshape(
            n, pad)[:, 2::-1]
        out[..., :3] = lut[index]
        return out
    if compression == 3:
        if bits == 32 and masks in _BMP_MASKS32:
            order = _BMP_MASKS32[masks]
        elif bits == 24 and masks[:3] == (0xFF0000, 0xFF00, 0xFF):
            order = (2, 1, 0, -1)
        elif bits == 16 and masks[:3] in ((0xF800, 0x7E0, 0x1F),
                                          (0x7C00, 0x3E0, 0x1F)):
            order = None
        else:
            raise _Unreadable(f"BMP bitfields {masks}")
    else:
        order = (2, 1, 0, -1)     # BGR, BGRX: the fourth byte is ignored
    if bits == 16:
        green = 6 if masks is not None and masks[0] == 0xF800 else 5
        px = rows.view("<u2").reshape(height, -1)[:, :width]
        out[..., :3] = _rgb15(px, green)
        return out
    px = rows.reshape(height, width, bits // 8)
    for c in range(3):
        out[..., c] = px[..., order[c]]
    if order[3] >= 0:
        out[..., 3] = px[..., order[3]]
    return out


def _decode_tga(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a TGA file, as TgaImagePlugin reads it."""
    id_len, has_map, kind = data[0], data[1], data[2]
    width, height = struct.unpack_from("<HH", data, 12)
    depth, flags = data[16], data[17]
    base = kind & 7
    if base not in (1, 2, 3) or kind & ~0xB:
        raise _Unreadable(f"TGA image type {kind}")
    if (base, depth) not in ((1, 8), (2, 24), (2, 32), (3, 8), (3, 16)):
        raise _Refused(f"image type {kind} at {depth} bits")
    pos = 18 + id_len
    lut = None
    if has_map:
        start, size, map_depth = struct.unpack_from("<HHB", data, 3)
        if map_depth == 16:
            raise _Refused("a 16-bit colour map")
        if map_depth != 24:       # PIL refuses 32-bit maps too
            raise _Unreadable(f"TGA map depth {map_depth}")
        k = map_depth // 8
        entries = data[pos:pos + k * size]
        pos += k * size
        if len(entries) != k * size:
            raise _Unreadable("truncated colour map")
        n = min(start + size, 256)
        lut = np.zeros((256, 3), np.uint8)
        lut[start:n] = np.frombuffer(entries, np.uint8).reshape(
            size, 3)[:n - start, ::-1]     # BGR entries
    npix, bpp = width * height, depth // 8
    if kind & 8:
        pixels = _tga_rle(data, pos, npix, bpp)
    else:
        if pos + npix * bpp > len(data):
            raise _Unreadable("truncated pixel data")
        pixels = np.frombuffer(data, np.uint8, npix * bpp, pos)
    px = pixels.reshape(height, width, bpp)
    if not flags & 0x20:          # bottom-up, the default origin
        px = px[::-1]
    if flags & 0x10:              # right to left
        px = px[:, ::-1]
    out = np.full((height, width, 4), 255, np.uint8)
    if base == 1 and has_map:
        out[..., :3] = lut[px[..., 0]]
    elif base != 2:               # grey (+ alpha), or indices without a map
        out[..., :3] = px[..., :1]
        if bpp == 2:
            out[..., 3] = px[..., 1]
    else:                         # BGR(A)
        out[..., :3] = px[..., [2, 1, 0]]
        if bpp == 4:
            out[..., 3] = px[..., 3]
    return out


def _tga_rle(data: bytes, pos: int, npix: int, bpp: int) -> np.ndarray:
    """The pixel bytes of a run-length TGA: packets of 1-128 pixels, a run
    of one pixel (header bit 7 set) or that many literal pixels."""
    out = bytearray()
    want = npix * bpp
    while len(out) < want:
        if pos >= len(data):
            raise _Unreadable("truncated run-length data")
        head = data[pos]
        n = (head & 0x7F) + 1
        if head & 0x80:
            px = data[pos + 1:pos + 1 + bpp]
            pos += 1 + bpp
            out += px * n
        else:
            px = data[pos + 1:pos + 1 + n * bpp]
            pos += 1 + n * bpp
            out += px
        if len(px) != (bpp if head & 0x80 else n * bpp):
            raise _Unreadable("truncated run-length data")
    return np.frombuffer(bytes(out[:want]), np.uint8)


_WHITESPACE = b" \t\n\x0b\x0c\r"


def _decode_pnm(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a binary PGM (P5) or PPM (P6) file with
    maxval 255, its header read as PpmImagePlugin reads it."""
    pos = 0
    magic = b""
    while pos < len(data) and len(magic) < 6:
        c = data[pos:pos + 1]
        pos += 1
        if c in _WHITESPACE:
            break
        magic += c
    if magic not in (b"P5", b"P6"):
        if magic in (b"P1", b"P2", b"P3", b"P4", b"Pf", b"P0CMYK", b"PyP",
                     b"PyRGBA", b"PyCMYK"):
            raise _Refused(f"{magic.decode()} (only binary P5 and P6 are "
                           "decoded)")
        raise _Unreadable("not a PNM file")

    def token():
        nonlocal pos
        tok = b""
        while len(tok) <= 10:
            c = data[pos:pos + 1]
            pos += 1
            if not c:
                break
            if c in _WHITESPACE:
                if not tok:
                    continue
                break
            if c == b"#":         # a comment runs to CR, LF or the end
                while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                    pos += 1
                pos += 1
                continue
            tok += c
        if not tok or len(tok) > 10:
            raise _Unreadable("bad PNM header")
        return int(tok)

    width, height, maxval = token(), token(), token()
    if not 0 < maxval < 65536 or width <= 0 or height <= 0:
        raise _Unreadable("bad PNM header")
    if maxval != 255:
        raise _Refused(f"maxval {maxval} (only 255 is decoded)")
    spp = 1 if magic == b"P5" else 3
    if pos + width * height * spp > len(data):
        raise _Unreadable("truncated pixel data")
    px = np.frombuffer(data, np.uint8, width * height * spp, pos).reshape(
        height, width, spp)
    out = np.full((height, width, 4), 255, np.uint8)
    out[..., :3] = px
    return out


_DECODERS = {"PNG": _decode_png, "JPEG": jpeg.decode_rgba,
             "BMP": _decode_bmp, "TGA": _decode_tga, "PNM": _decode_pnm}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: str, pixels: np.ndarray) -> None:
    """Write uint8 ``pixels``, [H, W] grey (mode ``L``) or [H, W, 3] RGB
    with row 0 = image top, as a PNG file: 8 bits, non-interlaced, every
    row under filter 0."""
    img = np.asarray(pixels)
    if img.dtype != np.uint8 or not (
            img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError("write_png: pixels must be uint8 [H, W] or "
                         f"[H, W, 3], got {img.dtype} {list(img.shape)}")
    h, w = img.shape[:2]
    colour = 0 if img.ndim == 2 else 2
    rows = np.zeros((h, 1 + img.size // max(h, 1)), np.uint8)
    rows[:, 1:] = img.reshape(h, -1)
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    data = (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def sample_nearest(img: "np.ndarray | None", u: float, v: float) -> np.ndarray:
    """Host-side ``tex2D`` for tests and tools (the device path is
    ``ops/texturing.py``)."""
    if img is None:
        return np.zeros(4, np.float32)
    if u > 1.0 or u < 0.0 or v > 1.0 or v < 0.0:
        return np.zeros(4, np.float32)
    h, w = img.shape[:2]
    x = min(int(w * u), w - 1)
    y = min(int(h * v), h - 1)
    return img[y, x]
