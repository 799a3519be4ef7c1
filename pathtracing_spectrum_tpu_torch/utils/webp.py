"""WebP for the port's textures: the binding of the host library's
decoder ``csrc/webp_decode.cpp``.

The decoder computes what libwebp's ``WebPAnimDecoder`` computes with
PIL's settings (RGBA, not premultiplied, fancy upsampling), so
:func:`decode_rgba` equals the JAX package's PIL decode bit for bit: VP8L
(lossless), VP8 (lossy) key frames, ALPH (raw or lossless, filters 0-3)
and an animation's first frame on its canvas. Its module comment lists
what it computes. It is host C++ (the entropy decoders are bit-serial) and
has no Python fallback: when the host library cannot be built, the call
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
