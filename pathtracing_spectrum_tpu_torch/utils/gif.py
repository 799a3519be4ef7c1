"""GIF for the port's image writer: the file PIL 12.1's ``Image.save``
writes for a ``.gif`` name, byte for byte, over the host library's
quantiser and LZW encoder ``csrc/gif_encode.cpp``.

PIL's ``GifImagePlugin._save`` at its defaults (no palette, transparency,
loop, duration or comment given; ``optimize`` set):

- grey (mode ``L``) keeps its levels: the used ones, in ascending order,
  become the palette (``_get_optimize`` always optimises ``L``;
  ``remap_palette`` renumbers the pixels);
- RGB goes through ``Image.convert("P", palette=Palette.ADAPTIVE)``, the
  median cut the host library computes; its palette is optimised the same
  way where the image has fewer than 512 x 512 pixels and the palette has
  holes (or would halve), else kept whole;
- a ``GIF87a`` header, the colour table padded with black to ``2 << n``
  entries (at least 4), the image descriptor (interlaced unless the
  smaller side is under 16 pixels), minimum code size 8, the LZW data
  sub-blocks, the block terminator and ``;``.

Host C++ (a 4K frame would take minutes in numpy); no Python fallback:
when the host library cannot be built, the call raises with the
compiler's output.
"""

from __future__ import annotations

import struct

import numpy as np

from .. import _build


def _remap(indices: np.ndarray, used: np.ndarray) -> np.ndarray:
    """``remap_palette(used)``: each index to its position in ``used``."""
    lut = np.zeros(256, np.uint8)
    lut[used] = np.arange(len(used), dtype=np.uint8)
    return lut[indices]


def _palette_p(indices: np.ndarray, palette: np.ndarray):
    """``_get_optimize`` and ``remap_palette`` for the quantiser's P
    image: the used entries in order where its heuristics ask for it."""
    h, w = indices.shape
    if w * h >= 512 * 512:
        return indices, palette
    used = np.flatnonzero(np.bincount(indices.ravel(), minlength=256))
    n = len(palette)
    current = 1 << (n - 1).bit_length()
    if used.max() >= len(used) or (len(used) <= current // 2
                                   and current > 2):
        return _remap(indices, used), palette[used]
    return indices, palette


def _table_size(n: int) -> int:
    """``_get_color_table_size`` of an ``n``-entry palette."""
    return 1 if n < 3 else (n - 1).bit_length() - 1


def encode(pixels: np.ndarray) -> bytes:
    """The GIF file PIL's ``Image.save`` writes for uint8 ``pixels``,
    [H, W] grey or [H, W, 3] RGB (row 0 = image top)."""
    lib = _build.load_host()
    img = np.ascontiguousarray(pixels, np.uint8)
    h, w = img.shape[:2]
    if img.size == 0:             # what PIL raises on the way
        if img.ndim == 2:
            raise SystemError("tile cannot extend outside image")
        raise ValueError("max() iterable argument is empty")
    if img.ndim == 2:
        used = np.flatnonzero(np.bincount(img.ravel(), minlength=256))
        indices = _remap(img, used)
        palette = np.repeat(used.astype(np.uint8)[:, None], 3, 1)
    else:
        indices = np.empty((h, w), np.uint8)
        entries = np.empty((256, 3), np.uint8)
        n = lib.pts_gif_quantize(img.ctypes.data, h * w, indices.ctypes.data,
                                 entries.ctypes.data)
        if n == 0:
            raise MemoryError("GIF quantiser: out of memory")
        indices, palette = _palette_p(indices, entries[:n])
    size = _table_size(len(palette))
    table = np.zeros((2 << size, 3), np.uint8)
    table[:len(palette)] = palette
    interlace = min(w, h) >= 16
    handle = lib.pts_gif_lzw_encode(indices.ctypes.data, w, h, int(interlace),
                                    max(65536, 4 * w))
    if not handle:
        raise MemoryError("GIF encoder: out of memory")
    try:
        data = np.empty(lib.pts_buffer_size(handle), np.uint8)
        lib.pts_buffer_copy(handle, data.ctypes.data)
    finally:
        lib.pts_buffer_free(handle)
    return (b"GIF87a" + struct.pack("<HHBBB", w, h, size + 128, 0, 0)
            + table.tobytes()
            + b"," + struct.pack("<HHHHBB", 0, 0, w, h,
                                 64 if interlace else 0, 8)
            + data.tobytes() + b"\0;")
