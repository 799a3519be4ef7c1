"""Host texture loading without PIL, and the reference's nearest sampling.

Port of ``pathtracing_spectrum_tpu/utils/image.py``. The JAX package
decodes with PIL; the port must not import it (the machine with the card
has none), so :func:`load_rgba` decodes PNG itself, with the standard
library's ``zlib`` and the five PNG row filters in numpy and Python. Its
output equals PIL's ``convert("RGBA")`` divided by 255, bit for bit:

- colour types 0 (grey, 1/2/4/8 bits), 2 (RGB), 3 (palette, 1/2/4/8
  bits), 4 (grey + alpha) and 6 (RGBA), non-interlaced;
- ``tRNS`` as PIL applies it: one transparent grey or RGB value, or one
  alpha per palette entry;
- a missing or unreadable file (no such path, a bad checksum, truncated
  data) returns ``None``, as the reference's ``Image`` fails soft to black
  (image.cpp:48-49);
- a PNG flavour it does not decode (16-bit samples, Adam7 interlace) and
  any file that is not a PNG raise ``NotImplementedError`` naming the
  file: a texture is never dropped quietly.

Sampling on the device is ``ops/texturing.py``; :func:`sample_nearest` is
the host ``tex2D`` for tests and tools. :func:`write_png` is the writer the
viewer and the CLI save through (8-bit grey or RGB; the JAX package saves
through PIL).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (samples per pixel, allowed bit depths)
_COLOUR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}


class _Unreadable(Exception):
    """The file is a PNG, but broken: fail soft like the reference."""


def load_rgba(path: str) -> "np.ndarray | None":
    """Load a PNG file as float32 RGBA [H, W, 4] in [0, 1] (row 0 = image
    top), equal to PIL's ``convert("RGBA")`` / 255. ``None`` when the file
    is missing or unreadable; ``NotImplementedError`` for a file that is
    not a PNG or a PNG flavour this decoder does not take."""
    if not path:
        return None
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if not data:
        return None
    if not data.startswith(_SIGNATURE):
        raise NotImplementedError(
            f"{path}: not a PNG file; the PyTorch port decodes PNG textures "
            "only (convert it to PNG; ROADMAP Queue 1 item 11)")
    try:
        rgba = _decode_png(data, path)
    except (_Unreadable, zlib.error, struct.error, ValueError, IndexError):
        return None
    return rgba.astype(np.float32) / 255.0


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


def _decode_png(data: bytes, path: str) -> np.ndarray:
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
    if depth == 16 or interlace:
        raise NotImplementedError(
            f"{path}: {'16-bit' if depth == 16 else 'interlaced'} PNG is not "
            "decoded by the PyTorch port; save it as 8-bit, non-interlaced "
            "(ROADMAP Queue 1 item 11)")
    if filt != 0 or width == 0 or height == 0:
        raise _Unreadable("bad header")
    if colour == 3 and palette is None:
        raise _Unreadable("palette image without PLTE")
    spp = _COLOUR_TYPES[colour][0]
    bits = spp * depth
    stride = (width * bits + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise _Unreadable("truncated image data")
    rows = _unfilter(raw, height, stride, max(1, bits // 8))
    if depth < 8:
        samples = _unpack(rows, depth, width)               # [H, W]
    else:
        samples = rows.reshape(height, width, spp)
        if spp == 1:
            samples = samples[..., 0]                       # [H, W]
    return _to_rgba(samples, colour, depth, palette, trns)


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
    h, w = samples.shape[:2]
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
        return pal[samples]
    if colour in (0, 4):
        grey = samples if samples.ndim == 2 else samples[..., 0]
        if depth < 8:
            grey = (grey * (255 // ((1 << depth) - 1))).astype(np.uint8)
        out[..., :3] = grey[..., None]
        if colour == 4:
            out[..., 3] = samples[..., 1]
        elif trns is not None and len(trns) >= 2:
            # PIL compares the 8-bit grey with the chunk's raw value (a
            # 1-bit image's as 0 or 255)
            key = struct.unpack(">H", trns[:2])[0]
            if depth == 1:
                key = 255 if key else 0
            out[..., 3] = np.where(grey == key, 0, 255)
        return out
    out[..., :3] = samples[..., :3]
    if colour == 6:
        out[..., 3] = samples[..., 3]
    elif trns is not None and len(trns) >= 6:
        key = struct.unpack(">HHH", trns[:6])
        match = ((samples[..., 0] == key[0]) & (samples[..., 1] == key[1])
                 & (samples[..., 2] == key[2]))
        out[..., 3] = np.where(match, 0, 255)
    return out


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
