"""WebP for the port's textures and image writer: the bindings of the
host library's decoder ``csrc/webp_decode.cpp`` and encoder
``csrc/webp_encode.cpp``.

The decoder computes what libwebp's ``WebPAnimDecoder`` computes with
PIL's settings (RGBA, not premultiplied, fancy upsampling), so
:func:`decode_rgba` equals the JAX package's PIL decode bit for bit: VP8L
(lossless), VP8 (lossy) key frames, ALPH (raw or lossless, filters 0-3)
and an animation's first frame on its canvas. Its module comment lists
what it computes.

The encoder computes libwebp 1.6's ``WebPEncode`` with the ``WebPConfig``
PIL passes, so :func:`encode` is the file PIL 12.1's ``Image.save`` writes
for a ``.webp`` name, byte for byte: lossy VP8 at quality 80, method 4,
four segments, SNS 50, filter strength 60 (sharpness 0, the normal
filter), one partition and one pass, from an opaque ARGB picture (PIL
turns L into RGB). Its module comment lists the stages.
:func:`encode_stages` hands the tests the stages' results.

Both are host C++ (each macroblock's mode decision depends on its
neighbours' reconstructions and the boolean coders are bit-serial) with
no Python fallback: when the host library cannot be built, the call
raises with the compiler's output.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import _build


class BrokenWebP(ValueError):
    """The file is a WebP, but broken (libwebp fails on it, PIL raises)."""


def decode_rgba(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a WebP file's bytes, row 0 = image top.

    Raises :class:`BrokenWebP` for a broken file (every flavour PIL reads
    is decoded)."""
    lib = _build.load_host()
    buf = np.frombuffer(data, np.uint8)
    status = ctypes.c_int32(0)
    msg = ctypes.create_string_buffer(256)
    handle = lib.pts_webp_decode(buf.ctypes.data, buf.size,
                                 ctypes.byref(status), msg, len(msg))
    if not handle:
        raise BrokenWebP(msg.value.decode(errors="replace"))
    try:
        w, h = ctypes.c_int32(0), ctypes.c_int32(0)
        lib.pts_webp_size(handle, ctypes.byref(w), ctypes.byref(h))
        out = np.empty((h.value, w.value, 4), np.uint8)
        lib.pts_webp_copy(handle, out.ctypes.data)
    finally:
        lib.pts_webp_free(handle)
    return out


# libwebp's VP8_ENC_ERROR codes the encoder returns, as PIL raises them
_ENCODE_ERRORS = {
    5: "encoding error 5: Image size exceeds WebP limit of 16383 pixels",
    6: "encoding error 6",
}


def _encoder_input(pixels: np.ndarray):
    img = np.ascontiguousarray(pixels, np.uint8)
    h, w = img.shape[:2]
    if h == 0 or w == 0:          # PIL's WebPPictureAlloc fails first
        raise MemoryError("can't allocate picture frame")
    return img, w, h, 1 if img.ndim == 2 else 3


def _check(status: int) -> None:
    if status == 1:
        raise MemoryError("WebP encoder: out of memory")
    if status:
        raise ValueError(_ENCODE_ERRORS[status])


def encode(pixels: np.ndarray) -> bytes:
    """The WebP file PIL's ``Image.save`` writes for uint8 ``pixels``,
    [H, W] grey or [H, W, 3] RGB (row 0 = image top). A side over 16,383
    pixels raises PIL's ``ValueError``, an empty image its
    ``MemoryError``."""
    img, w, h, ch = _encoder_input(pixels)
    lib = _build.load_host()
    status = ctypes.c_int32(0)
    handle = lib.pts_webp_encode(img.ctypes.data, w, h, ch,
                                 ctypes.byref(status))
    if not handle:
        _check(status.value)
    try:
        data = np.empty(lib.pts_buffer_size(handle), np.uint8)
        lib.pts_buffer_copy(handle, data.ctypes.data)
    finally:
        lib.pts_buffer_free(handle)
    return data.tobytes()


def encode_stages(pixels: np.ndarray) -> dict:
    """The encoder's intermediate results for ``pixels``, for the tests
    (the writer never calls it): ``y``, ``u`` and ``v``, the YUV 4:2:0
    planes; per macroblock ([mb_h, mb_w] uint8 each, as libwebp's
    ``extra_info`` reports them) ``type`` (1: 16x16, 0: 4x4),
    ``segment``, ``quant``, ``mode16`` (255 for 4x4) ``uv_mode`` and
    ``skip``; per segment ``segment_quant`` and ``segment_level`` (the
    filter strength)."""
    img, w, h, ch = _encoder_input(pixels)
    lib = _build.load_host()
    y = np.empty((h, w), np.uint8)
    u = np.empty(((h + 1) // 2, (w + 1) // 2), np.uint8)
    v = np.empty_like(u)
    mb = np.empty(((h + 15) // 16, (w + 15) // 16, 6), np.uint8)
    seg = np.empty(8, np.int32)
    _check(lib.pts_webp_encode_stages(img.ctypes.data, w, h, ch,
                                      y.ctypes.data, u.ctypes.data,
                                      v.ctypes.data, mb.ctypes.data,
                                      seg.ctypes.data))
    names = ("type", "segment", "quant", "mode16", "uv_mode", "skip")
    return {"y": y, "u": u, "v": v,
            **{n: mb[..., i] for i, n in enumerate(names)},
            "segment_quant": seg[:4], "segment_level": seg[4:]}
