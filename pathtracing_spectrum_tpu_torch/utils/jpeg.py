"""JPEG for the port's textures and image files: the binding of the host
library's decoder ``csrc/jpeg_decode.cpp`` and encoder
``csrc/jpeg_encode.cpp``.

The decoder computes what libjpeg-turbo computes with PIL's settings (the
islow IDCT, fancy upsampling, integer YCbCr -> RGB, YCCK -> CMYK), so
:func:`decode_rgba` equals the JAX package's PIL decode bit for bit: 1, 3
or 4 components (grey, YCbCr or RGB, CMYK or YCCK), Huffman or
arithmetic coding, sequential or progressive. Its module comment lists
what it reads and what it refuses (lossless Huffman frames, progressive
files that libjpeg would smooth). :class:`TiffDecoder` reads the strips
and tiles of a JPEG-compressed TIFF (compression 7) as libtiff 4.7's JPEG
codec hands libjpeg's samples to PIL. It is host C++
(Huffman decoding is bit-serial; in Python a 2048x2048 texture would take
minutes) and has no Python fallback: when the host library cannot be
built, the call raises with the compiler's output. :func:`encode` writes
the file PIL's ``Image.save`` writes at its defaults, byte for byte.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build


class BrokenJpeg(ValueError):
    """The file is a JPEG, but broken (PIL raises on it too)."""


def decode_rgba(data: bytes, cmyk_space: bool = False) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a JPEG file's bytes, row 0 = image top: PIL's
    ``convert("RGBA")`` of the image it opens (a 4-component file as mode
    ``CMYK``, through :func:`inverted_cmyk_rgba`). ``cmyk_space`` decodes a
    4-component stream as libjpeg does under ``jpeg_color_space`` CMYK
    (PIL's jpegmode ``"CMYK"``, which its BLP plugin sets): an Adobe
    transform naming YCCK is not applied.

    Raises :class:`BrokenJpeg` for a broken file and
    ``NotImplementedError`` (with the reason) for a flavour the decoder
    does not read."""
    lib = _build.load_host()
    buf = np.frombuffer(data, np.uint8)
    out, n = _image(lib, _call(lambda status, msg: lib.pts_jpeg_decode(
        buf.ctypes.data, buf.size, int(cmyk_space), status, msg,
        len(msg))))
    return inverted_cmyk_rgba(out) if n == 4 else out


class TiffDecoder:
    """The strips or tiles of one JPEG-compressed TIFF as libtiff's JPEG
    codec (tif_jpeg.c) decodes them for PIL: each an abbreviated JPEG
    stream read after the file's JPEGTables (``tables``, tag 347, or None)
    and the tables of the streams before it (libjpeg keeps them), libtiff's
    fake EOI markers past its end, and JPEGPreDecode's checks against the
    strip or tile. The host library holds the tables until
    :meth:`close` (or the object's end)."""

    def __init__(self, tables: "bytes | None"):
        lib = _build.load_host()
        buf = np.frombuffer(tables or b"", np.uint8)
        self._handle = _call(lambda status, msg: lib.pts_jpeg_tables(
            buf.ctypes.data if buf.size else None, buf.size, status, msg,
            len(msg)))

    def __del__(self):
        self.close()

    def close(self) -> None:
        if getattr(self, "_handle", None):
            _build.load_host().pts_jpeg_tables_free(self._handle)
        self._handle = None

    def decode(self, data: bytes, seg_w: int, seg_h: int, spp: int,
               sampling, last_strip: bool, ycbcr: bool,
               want_rows: int) -> np.ndarray:
        """[H, W, spp] uint8 samples of one strip or tile's stream, as
        libjpeg hands them to libtiff: RGB where ``ycbcr`` (photometric
        YCbCr, JPEGCOLORMODE_RGB), else the components as stored (CMYK not
        inverted). The stream must fit the ``seg_w`` x ``seg_h`` segment
        (taller only for the ``last_strip``), hold ``spp`` components, its
        first sampled ``sampling`` (h, v) and the others 1x1; libtiff reads
        ``want_rows`` rows of it (a single-scan stream no further). H and
        W may be smaller than the segment (libtiff warns and reads what
        there is). Raises :class:`BrokenJpeg` where libtiff fails and
        ``NotImplementedError`` for a stream the decoder does not read."""
        lib = _build.load_host()
        buf = np.frombuffer(data, np.uint8)
        hs, vs = sampling
        out, n = _image(lib, _call(
            lambda status, msg: lib.pts_jpeg_tiff_decode(
                self._handle, buf.ctypes.data if buf.size else None,
                buf.size, seg_w, seg_h, spp, hs, vs, int(last_strip),
                int(ycbcr), want_rows, status, msg, len(msg))))
        return out[..., :3 if ycbcr else n]


def _call(fn):
    """fn(status, msg) of a decoder entry point: its handle, or the
    exception its status names."""
    status = ctypes.c_int32(0)
    msg = ctypes.create_string_buffer(256)
    handle = fn(ctypes.byref(status), msg)
    if not handle:
        what = msg.value.decode(errors="replace")
        if status.value == 2:
            raise NotImplementedError(what)
        raise BrokenJpeg(what)
    return handle


def _image(lib, handle):
    """([H, W, 4] uint8 pixels, components) of a decoded image's handle,
    which it releases."""
    try:
        w, h, n = (ctypes.c_int32(0) for _ in range(3))
        lib.pts_jpeg_size(handle, ctypes.byref(w), ctypes.byref(h),
                          ctypes.byref(n))
        out = np.empty((h.value, w.value, 4), np.uint8)
        lib.pts_jpeg_copy(handle, out.ctypes.data)
    finally:
        lib.pts_jpeg_free(handle)
    return out, n.value


def _cmyk2rgb_table() -> np.ndarray:
    """[stored C, M or Y sample, stored K sample] -> R, G or B: PIL's
    ``cmyk2rgb`` of samples stored inverted (``c = 255 - sample``), each
    channel ``nk - c * nk / 255`` with ``nk = 255 - k``, rounded as its
    ``MULDIV255``."""
    s = np.arange(256, dtype=np.int32)
    c, nk = 255 - s[:, None], s[None, :]
    t = c * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


_CMYK2RGB = _cmyk2rgb_table().reshape(-1)


def inverted_cmyk_rgba(samples: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 RGBA of CMYK samples stored inverted, as PIL reads
    them (rawmode ``CMYK;I``: JPEG's Adobe convention, and PSD) and
    converts them to RGBA."""
    out = np.empty(samples.shape[:-1] + (4,), np.uint8)
    idx = samples[..., :3].astype(np.uint16) << 8 | samples[..., 3:]
    out[..., :3] = _CMYK2RGB[idx]
    out[..., 3] = 255
    return out


def encode(pixels: np.ndarray) -> bytes:
    """The JPEG file PIL's ``Image.save`` writes at its defaults for uint8
    ``pixels``, [H, W] grey or [H, W, 3] RGB (row 0 = image top), byte for
    byte: ``csrc/jpeg_encode.cpp`` lists what it computes."""
    lib = _build.load_host()
    img = np.ascontiguousarray(pixels, np.uint8)
    h, w = img.shape[:2]
    if h == 0 or w == 0:          # JpegImagePlugin._save's check
        raise ValueError("cannot write empty image as JPEG")
    if max(h, w) > 65500:         # libjpeg's JPEG_MAX_DIMENSION
        raise ValueError(f"image too large for JPEG: {w}x{h}")
    handle = lib.pts_jpeg_encode(img.ctypes.data, w, h,
                                 1 if img.ndim == 2 else 3)
    if not handle:
        raise MemoryError("JPEG encoder: out of memory")
    try:
        out = np.empty(lib.pts_buffer_size(handle), np.uint8)
        lib.pts_buffer_copy(handle, out.ctypes.data)
    finally:
        lib.pts_buffer_free(handle)
    return out.tobytes()
