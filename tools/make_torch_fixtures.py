#!/usr/bin/env python3
"""Write the image fixtures of the PyTorch port into ``tests/torch_data/``.

The machine with the card has no PIL, so ``chip_smoke.py`` holds the
port's decodes and writes there by digest. This script makes each fixture
with PIL (or by hand, for the PNG, TIFF, GIF and PSD flavours PIL does not
write) and records, in ``tests/torch_data/digests.json``, the sha256 of
PIL's ``convert("RGBA")`` bytes of each. For the 16-bit grey PNG, TIFF
and P5 it records the high-byte image instead: the port's named deviation
from PIL, which clips that mode at 255. ``tests/test_torch_formats.py`` checks
the digests against PIL's decode on every run.

It also records, in ``tests/torch_data/write_digests.json``, the sha256
of the file PIL's ``Image.save`` writes for two images (the 37x29 fixture
image and a 3840x2160 one made procedurally, in integers only, by
:func:`writer_images`) as L and RGB under each extension the port writes
byte for byte; no image is committed for these. ``chip_smoke.py`` imports
:func:`writer_images` from this file (PIL is imported only where it is
used).

And it records, in ``tests/torch_data/map_digests.json``, the sha256 of
each of ``READER_MAPS`` (the textured sessions' RLE SGI roughness map and
PCX normal map, uncompressed CMYK roughness map and PackBits YCbCr
normal map as TIFFs, and a JPEG-in-TIFF normal map in 256x256 tiles,
made at run time by :func:`reader_map`: nothing is committed) and of
PIL's decode of it; ``chip_smoke.py`` holds the maps it builds and the
port's decodes of them to these.

Fixtures (all content procedural, from fixed seeds):

- ``roughness_2048_prog420.jpg``: 2048x2048 progressive 4:2:0 JPEG,
  quality 90, smooth ramps and waves (the textured 1080p session's
  roughness map);
- ``normal_1024_444.jpg``: 1024x1024 baseline 4:4:4 JPEG, quality 90, a
  field of bumps encoded as tangent-space normals (its normal map);
- ``roughness_2048_ycck_arith_prog.jpg``: 2048x2048 YCCK (an Adobe marker
  with transform 2), arithmetic-coded progressive (SOF10), Y and K at
  2x2, quality 75, four fields varying over half a period (libjpeg
  itself writes it: PIL writes neither YCCK nor arithmetic coding), and
  ``normal_1024_cmyk_arith.jpg``: 1024x1024 CMYK (transform 0),
  arithmetic-coded sequential (SOF9) at 4:4:4, a restart interval of a
  row of MCUs, DAC conditioning L=1, U=4, K=12, quality 75, the normal
  map's content with two bumps a side; both under 64 KiB, the most
  of an arithmetic-coded file PIL decodes (the textured sessions' maps of
  ``chip_smoke.py``'s ``jpeg-flavours`` turn);
- ``small_cmyk.jpg`` (PIL's CMYK save), ``small_ycck_prog.jpg`` (libjpeg's
  Huffman progressive YCCK) and ``small_grey_arith.jpg`` (grey SOF9),
  37x29;
- ``small.bmp`` (24-bit), ``small.tga`` (run-length RGBA), ``small.ppm``
  (P6), ``grey16.png`` (16-bit grey) and ``adam7.png`` (8-bit RGB,
  Adam7-interlaced), 37x29 each;
- ``roughness_2048_deflate.tif``: 2048x2048 8-bit grey, Deflate with
  predictor 2, written by libtiff through PIL (the first channel of the
  JPEG roughness map's content);
- ``normal_512_lzw16.tif``: 512x512 16-bit RGB tangent-space normals at
  10-bit precision, LZW with predictor 2, 16-row strips (by hand: PIL
  holds no 16-bit RGB);
- ``interlaced.gif`` (37x29, interlaced, a transparency index),
  ``tiled_planar.tif`` (37x29 8-bit RGB, 16x16 tiles, separate planes,
  LZW), ``grey16.tif`` (37x29 16-bit grey, its digest the high-byte
  image), ``rle.psd`` (37x29 RGBA, RLE) and ``assoc_alpha.tif`` (37x29
  RGBA with associated alpha, PackBits);
- ``small.pbm`` (PIL's P4 of mode 1), ``grey16.pgm`` (PIL's P5 of mode
  I;16 at maxval 65535, its digest the high-byte image), ``small16.ppm``
  and ``small_1000.ppm`` (P6 at maxval 65535 and 1000, by hand: PIL
  writes P6 at 255 only), ``small.pfm`` (PIL's Pf of mode F),
  ``small_1bit.tga`` (PIL's TGA of mode 1) and ``small_i32_lzw.tif``
  (PIL's LZW TIFF of mode I), 37x29;
- ``roughness_2048_lossy.webp`` (the roughness map's content as a lossy
  WebP, quality 80), ``normal_1024_lossless.webp`` (the normal map as a
  lossless WebP whose alpha is the bump height), and 37x29
  ``small_lossy.webp`` (VP8), ``small_lossy_alpha.webp`` (VP8X with an
  ALPH chunk), ``small_palette.webp`` (VP8L colour indexing, five
  colours) and ``small_anim.webp`` (two frames, the first cropped to a
  window at an offset);
- PIL's JPEG-compressed TIFFs (compression 7, JPEGTables, abbreviated
  streams in strips) of modes L, RGB, CMYK and YCbCr (``small_jpeg_l``,
  ``_rgb``, ``_cmyk``, ``_ycbcr.tif``), and two wrapped by hand at 4:2:0
  without the YCbCrSubsampling tag: ``small_jpeg420_strips.tif`` (two
  16-row strips, whole JPEG files, no JPEGTables) and
  ``small_jpeg420_tiles.tif`` (16x16 tiles cut at the edges, abbreviated
  streams, JPEGTables), 37x29;
- PIL's CCITT TIFFs of mode 1, 37x29: ``small_g3_1d.tif`` (Group 3, 1-D
  rows after EOLs), ``small_g3_2d.tif`` (T4Options 1, 8-row strips),
  ``small_g3_eol_aligned.tif`` (T4Options 4), ``small_g4_miniswhite.tif``
  (Group 4, photometric 0), ``small_g4_fill2.tif`` (Group 4, fill order
  2, 8-row strips) and ``small_ccitt_rle.tif`` (compression 2); and
  ``roughness_2048_g4.tif``, a 2048x2048 bilevel Group 4 map of 32-pixel
  cells (:func:`roughness_bilevel`: the textured session's roughness map
  of ``chip_smoke.py``'s ``tiff-jpeg-ccitt`` turn).

Run from the repository root: ``python3 tools/make_torch_fixtures.py``.
"""

import hashlib
import importlib.util
import io
import json
import os
import struct
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "tests", "torch_data")
SMALL = (29, 37)     # (H, W), odd on purpose


def _images_module():
    spec = importlib.util.spec_from_file_location(
        "torch_images", os.path.join(HERE, "tests", "torch_images.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def roughness_bilevel(n: int = 2048, cell: int = 32) -> np.ndarray:
    """[n, n] bool: cells of ``cell`` pixels set where two waves over the
    cell indices cross: a blocky pattern, ~13 KB in Group 4."""
    i, j = np.mgrid[0:n // cell, 0:n // cell]
    on = ((i * 7 + j * 3) % 11 < 5) ^ ((i * j) % 5 == 0)
    return np.kron(on, np.ones((cell, cell), bool))


def roughness_map(n: int = 2048) -> np.ndarray:
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / n
    r = 0.5 + 0.5 * np.sin(6.2831853 * (3 * xx + 2 * yy)) * np.cos(
        6.2831853 * 4 * yy)
    g = 0.5 + 0.5 * np.sin(6.2831853 * (5 * xx * yy + xx))
    b = 0.5 + 0.5 * np.cos(6.2831853 * (2 * xx - 3 * yy))
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def normal_map(n: int = 1024, bumps: int = 8) -> np.ndarray:
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) * (bumps / n)
    # height sin(2 pi x) sin(2 pi y): tangent-space normal (-dh/dx, -dh/dy, 1)
    dx = 0.6 * np.cos(6.2831853 * xx) * np.sin(6.2831853 * yy)
    dy = 0.6 * np.sin(6.2831853 * xx) * np.cos(6.2831853 * yy)
    nrm = np.stack([-dx, -dy, np.ones_like(dx)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return ((nrm * 0.5 + 0.5) * 255).round().astype(np.uint8)


def normal_map16(n: int = 512, bumps: int = 4) -> np.ndarray:
    """:func:`normal_map`'s normals at 10-bit precision in 16-bit samples
    (float64, so the committed file does not depend on float32 sin)."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64) * (bumps / n)
    dx = 0.6 * np.cos(6.2831853 * xx) * np.sin(6.2831853 * yy)
    dy = 0.6 * np.sin(6.2831853 * xx) * np.cos(6.2831853 * yy)
    nrm = np.stack([-dx, -dy, np.ones_like(dx)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return ((nrm * 0.5 + 0.5) * 1023).round().astype(np.int64) * 64


def roughness_cmyk(n: int = 2048) -> np.ndarray:
    """[n, n, 4] uint8 CMYK samples of four fields that vary over half a
    period across the map: smooth enough that the arithmetic-coded JPEG
    stays within the 64 KiB PIL first hands libjpeg, whose arithmetic
    decoder cannot wait for more (a larger file is None in PIL)."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / n
    f = [0.5 + 0.4 * np.sin(3.1415927 * (xx + 0.5 * yy)),
         0.5 + 0.4 * np.cos(3.1415927 * (yy - 0.3 * xx)),
         0.5 + 0.4 * np.sin(3.1415927 * xx * yy),
         0.3 + 0.2 * np.cos(3.1415927 * (xx - yy))]
    return (np.stack(f, -1) * 255).astype(np.uint8)


def bump_height(n: int = 1024, bumps: int = 8) -> np.ndarray:
    """[n, n, 1] uint8: the height whose normals :func:`normal_map` holds
    (the alpha plane of the lossless WebP normal map)."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) * (bumps / n)
    h = np.sin(6.2831853 * xx) * np.sin(6.2831853 * yy)
    return ((h * 0.5 + 0.5) * 255).round().astype(np.uint8)[..., None]


def first_frame(small: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """The first frame of the animated WebP: the small image with alpha in
    a 20x16 window, transparent black around it (libwebp's encoder crops
    the key frame to the window, at an offset)."""
    frame = np.zeros(small.shape[:2] + (4,), np.uint8)
    frame[4:20, 6:26] = np.concatenate([small, alpha], -1)[4:20, 6:26]
    frame[4:20, 6:26, 3] |= 1
    return frame


def procedural_rgb(w: int, h: int, seed: int) -> np.ndarray:
    """[h, w, 3] uint8 of ramps, stripes and hashed noise, in integer
    arithmetic only, so every machine makes the same bytes."""
    y, x = np.mgrid[0:h, 0:w].astype(np.int64)
    hsh = (x * 73856093) ^ (y * 19349663) ^ (seed * 83492791)
    hsh = ((hsh ^ (hsh >> 13)) * 1274126177) & 0xFFFFFFFF
    noise = (hsh >> 24) & 63
    r = x * 255 // max(w - 1, 1)
    g = (y * 3 + (x // 17) * 40) % 256
    b = ((x // 64 + y // 64) % 2) * 160 + noise
    return np.clip(np.stack([r + noise // 4, g, b], -1), 0, 255).astype(
        np.uint8)


def sgi_rle_bytes(pixels: np.ndarray, name: bytes = b"",
                  bpc: int = 1) -> bytes:
    """An SGI file with RLE rows (compression 1), which neither PIL nor the
    port writes, of [H, W] or [H, W, Z] pixels (Z 3 or 4; uint8, or
    uint16 samples at ``bpc`` 2), row 0 the image's top. Rows bottom-up,
    channel-major tables of starts and lengths (in bytes) after the
    512-byte header, then each row's packets: a run of 2 to 127 equal
    samples as the count and the sample, the samples between runs as
    literal packets (``0x80 | count`` and up to 127 samples), a 0 count
    ending the row; at ``bpc`` 2 every count and sample is a big-endian
    16-bit word. In numpy over the whole image (no loop over runs)."""
    px = np.asarray(pixels)
    px = px[..., None] if px.ndim == 2 else px
    h, w, z = px.shape
    dimension = 3 if z > 1 else (1 if h == 1 else 2)
    rows = np.moveaxis(px[::-1], -1, 0).reshape(z * h, w).astype(np.int64)
    v = rows.ravel()
    start = np.ones(v.size, bool)
    start[1:] = v[1:] != v[:-1]
    start[::w] = True                         # a row starts a run
    pos = np.flatnonzero(start)
    length = np.diff(np.append(pos, v.size))
    single = length == 1
    # a segment: a run of 2 or more, or the singles that follow one
    # another in a row (one literal stretch)
    joins = np.zeros_like(single)
    joins[1:] = single[1:] & single[:-1] & (pos[1:] // w == pos[:-1] // w)
    seg = ~joins
    seg_id = np.cumsum(seg) - 1
    seg_len = np.bincount(seg_id, weights=length).astype(np.int64)
    seg_pos, literal = pos[seg], single[seg]
    # packets of at most 127 samples
    n_pk = (seg_len + 126) // 127
    first = np.cumsum(n_pk) - n_pk
    k = np.arange(n_pk.sum()) - np.repeat(first, n_pk)
    pk_start = np.repeat(seg_pos, n_pk) + 127 * k
    pk_count = np.minimum(np.repeat(seg_len, n_pk) - 127 * k, 127)
    pk_lit = np.repeat(literal, n_pk)
    pk_row = pk_start // w
    size = np.where(pk_lit, 1 + pk_count, 2)     # words (counts, samples)
    row_words = np.bincount(pk_row, weights=size,
                            minlength=z * h).astype(np.int64) + 1
    row_at = np.cumsum(row_words) - row_words
    at = row_at[pk_row] + (np.cumsum(size) - size) - (
        np.cumsum(row_words - 1) - (row_words - 1))[pk_row]
    words = np.zeros(int(row_words.sum()), np.int64)   # the 0 counts
    words[at] = pk_count | np.where(pk_lit, 0x80, 0)
    words[at[~pk_lit] + 1] = v[pk_start[~pk_lit]]
    lit_n = pk_count[pk_lit]
    off = np.arange(lit_n.sum()) - np.repeat(np.cumsum(lit_n) - lit_n,
                                             lit_n)
    words[np.repeat(at[pk_lit] + 1, lit_n) + off] = v[
        np.repeat(pk_start[pk_lit], lit_n) + off]
    body = words.astype(np.uint8 if bpc == 1 else ">u2").tobytes()
    starts = 512 + 8 * z * h + bpc * row_at
    head = (struct.pack(">hBBHHHHll4s79ss", 474, 1, bpc, dimension, w, h, z,
                        0, 255 if bpc == 1 else 65535, b"", name, b"")
            + struct.pack(">l404s", 0, b""))
    return (head + starts.astype(">u4").tobytes()
            + (bpc * row_words).astype(">u4").tobytes() + body)


def packbits_rows(rows: np.ndarray) -> "tuple[bytes, np.ndarray]":
    """(PackBits bytes, bytes of each row) of [R, N] uint8 rows, each row
    coded apart: a run of 2 to 128 equal bytes as ``257 - count`` and the
    byte (a run's last byte alone as a literal of one), the bytes between
    runs as literal packets (``count - 1`` and up to 128 bytes). In numpy
    over the whole image (no loop over runs)."""
    r, w = rows.shape
    v = rows.ravel().astype(np.int64)
    start = np.ones(v.size, bool)
    start[1:] = v[1:] != v[:-1]
    start[::w] = True                         # a row starts a run
    pos = np.flatnonzero(start)
    length = np.diff(np.append(pos, v.size))
    single = length == 1
    joins = np.zeros_like(single)             # singles that follow one
    joins[1:] = single[1:] & single[:-1] & (pos[1:] // w == pos[:-1] // w)
    seg = ~joins                              # another in a row
    seg_len = np.bincount(np.cumsum(seg) - 1, weights=length).astype(
        np.int64)
    seg_pos, literal = pos[seg], single[seg]
    n_pk = (seg_len + 127) // 128             # packets of at most 128
    k = np.arange(n_pk.sum()) - np.repeat(np.cumsum(n_pk) - n_pk, n_pk)
    pk_start = np.repeat(seg_pos, n_pk) + 128 * k
    pk_count = np.minimum(np.repeat(seg_len, n_pk) - 128 * k, 128)
    pk_lit = np.repeat(literal, n_pk)
    size = np.where(pk_lit, 1 + pk_count, 2)
    at = np.cumsum(size) - size
    out = np.zeros(int(size.sum()), np.int64)
    out[at] = np.where(pk_lit, pk_count - 1, (257 - pk_count) & 0xFF)
    out[at[~pk_lit] + 1] = v[pk_start[~pk_lit]]
    lit_n = pk_count[pk_lit]
    off = np.arange(lit_n.sum()) - np.repeat(np.cumsum(lit_n) - lit_n,
                                             lit_n)
    out[np.repeat(at[pk_lit] + 1, lit_n) + off] = v[
        np.repeat(pk_start[pk_lit], lit_n) + off]
    row_bytes = np.bincount(pk_start // w, weights=size,
                            minlength=r).astype(np.int64)
    return out.astype(np.uint8).tobytes(), row_bytes


def tiff_map_bytes(samples: np.ndarray, photometric: int,
                   packbits: bool = False, rows_per_strip: int = 16) -> bytes:
    """A little-endian one-IFD TIFF of [H, W, S] uint8 samples (S 3 or 4,
    contiguous), uncompressed or PackBits (:func:`packbits_rows`), in
    strips of ``rows_per_strip`` rows after the IFD; a YCbCr file
    (photometric 6) says subsampling (1, 1) and PIL's
    ReferenceBlackWhite (0, 255, 128, 255, 128, 255)."""
    h, w, spp = samples.shape
    rows = np.ascontiguousarray(samples).reshape(h, w * spp)
    if packbits:
        body, row_bytes = packbits_rows(rows)
    else:
        body, row_bytes = rows.tobytes(), np.full(h, w * spp, np.int64)
    strips = np.add.reduceat(row_bytes, np.arange(0, h, rows_per_strip))
    S, L, R = 3, 4, 5
    tags = {256: (L, [w]), 257: (L, [h]), 258: (S, [8] * spp),
            259: (S, [32773 if packbits else 1]), 262: (S, [photometric]),
            273: (L, [0] * len(strips)), 277: (S, [spp]),
            278: (L, [rows_per_strip]), 279: (L, [int(n) for n in strips]),
            284: (S, [1])}
    if photometric == 6:
        tags[530] = (S, [1, 1])
        tags[532] = (R, [0, 1, 255, 1, 128, 1, 255, 1, 128, 1, 255, 1])
    return _le_tiff(tags, 273, strips, body)


def jpeg_tiff_map_bytes(rgb: np.ndarray, tile: int = 256) -> bytes:
    """A little-endian one-IFD JPEG-in-TIFF (compression 7, photometric
    YCbCr, no YCbCrSubsampling tag: libtiff takes the first tile's 2x2)
    of [H, W, 3] uint8 RGB in ``tile``-square tiles after the IFD, each
    the JPEG file of its tile that PIL's ``Image.save`` writes (quality
    75, 4:2:0), as the port's ``utils/jpeg.py`` writes it."""
    sys.path.insert(0, HERE)
    from pathtracing_spectrum_tpu_torch.utils import jpeg
    h, w, _ = rgb.shape
    chunks = [jpeg.encode(np.ascontiguousarray(rgb[y:y + tile, x:x + tile]))
              for y in range(0, h, tile) for x in range(0, w, tile)]
    S, L = 3, 4
    tags = {256: (L, [w]), 257: (L, [h]), 258: (S, [8, 8, 8]),
            259: (S, [7]), 262: (S, [6]), 277: (S, [3]), 284: (S, [1]),
            322: (L, [tile]), 323: (L, [tile]), 324: (L, [0] * len(chunks)),
            325: (L, [len(c) for c in chunks])}
    return _le_tiff(tags, 324, np.array([len(c) for c in chunks]),
                    b"".join(chunks))


def _le_tiff(tags: dict, offsets_tag: int, sizes: np.ndarray,
             body: bytes) -> bytes:
    """A little-endian TIFF of one IFD at 8 holding ``tags`` ({tag: (type,
    values)}, types 3, 4 and 5), the values that do not fit an entry
    after it, then ``body``: the strips or tiles of ``sizes`` bytes whose
    offsets ``offsets_tag`` receives."""
    S, L, R = 3, 4, 5
    aux_at = 8 + 2 + 12 * len(tags) + 4
    aux_len = sum(len(v) * (2 if k == S else 4) for k, v in tags.values()
                  if len(v) * (2 if k == S else 4) > 4)
    at = aux_at + aux_len + np.cumsum(sizes) - sizes
    tags[offsets_tag] = (L, [int(a) for a in at])
    entries, aux = b"", b""
    for tag in sorted(tags):
        kind, values = tags[tag]
        data = struct.pack("<" + {S: "H", L: "I", R: "I"}[kind] * len(values),
                           *values)
        count = len(values) // (2 if kind == R else 1)
        if len(data) <= 4:
            value = data.ljust(4, b"\0")
        else:
            value = struct.pack("<I", aux_at + len(aux))
            aux += data
        entries += struct.pack("<HHI", tag, kind, count) + value
    return (b"II*\0" + struct.pack("<IH", 8, len(tags)) + entries
            + b"\0" * 4 + aux + body)


def cmyk_of(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 4] uint8 CMYK samples of RGB: the inverted channels with a
    black of the darkest, halved, taken out (integers only)."""
    c = 255 - rgb.astype(np.int64)
    k = c.min(-1, keepdims=True) // 2
    return np.concatenate([c - k, k], -1).astype(np.uint8)


def ycbcr_of(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 YCbCr samples of RGB by JPEG's fixed-point BT.601
    (16 fractional bits, integers only)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half = 1 << 15
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = ((-11059 * r - 21709 * g + 32768 * b + half) >> 16) + 128
    cr = ((32768 * r - 27439 * g - 5329 * b + half) >> 16) + 128
    return np.clip(np.stack([y, cb, cr], -1), 0, 255).astype(np.uint8)


# the textured sessions' maps read by the SGI, PCX and TIFF readers, made
# at run time (nothing is committed): a 2048x2048 RGB roughness map as an
# RLE SGI file (sgi_rle_bytes) and a 1024x1024 RGB normal map as the PCX
# file Image.save writes (which the port's writer writes byte for byte);
# a 2048x2048 roughness map as an uncompressed CMYK TIFF and a 1024x1024
# normal map as a YCbCr TIFF in PackBits at subsampling (1, 1)
# (tiff_map_bytes); a 1024x1024 normal map as a JPEG-in-TIFF in 256x256
# tiles (jpeg_tiff_map_bytes); their content is procedural_rgb's, in
# integers only
READER_MAPS = {"roughness_2048_rle.sgi": (2048, 11),
               "normal_1024.pcx": (1024, 12),
               "roughness_2048_cmyk.tif": (2048, 13),
               "normal_1024_ycbcr_packbits.tif": (1024, 14),
               "normal_1024_jpeg_tiles.tif": (1024, 16)}


def reader_map(name: str) -> "tuple[np.ndarray | None, bytes | None]":
    """(RGB pixels, file bytes) of one of ``READER_MAPS``: the RLE SGI
    file's bytes from :func:`sgi_rle_bytes`; None for the PCX, which the
    writer under test (PIL's or the port's ``write_image``) makes; for the
    TIFFs, whose samples are CMYK and YCbCr or JPEG streams, no RGB
    pixels and the bytes of :func:`tiff_map_bytes` or
    :func:`jpeg_tiff_map_bytes`."""
    n, seed = READER_MAPS[name]
    px = procedural_rgb(n, n, seed)
    if name.endswith(".sgi"):
        return px, sgi_rle_bytes(px, name=b"roughness")
    if name.endswith("_cmyk.tif"):
        return None, tiff_map_bytes(cmyk_of(px), 5)
    if name.endswith("_ycbcr_packbits.tif"):
        return None, tiff_map_bytes(ycbcr_of(px), 6, packbits=True)
    if name.endswith("_jpeg_tiles.tif"):
        return None, jpeg_tiff_map_bytes(px)
    return px, None


def reader_map_digests() -> dict:
    """{map: {"file_sha256", "rgba_sha256", "shape", "of"}}: the sha256 of
    each map's file (the RLE SGI encoder's output, PIL's PCX file) and of
    PIL's ``convert("RGBA")`` of it."""
    import tempfile
    from PIL import Image
    ti = _images_module()
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in READER_MAPS:
            px, data = reader_map(name)
            if data is None:
                path = os.path.join(tmp, name)
                Image.fromarray(px).save(path)
                with open(path, "rb") as f:
                    data = f.read()
            rgba = ti.pil_rgba8(data)
            out[name] = {"file_sha256": hashlib.sha256(data).hexdigest(),
                         "rgba_sha256": hashlib.sha256(
                             rgba.tobytes()).hexdigest(),
                         "shape": list(rgba.shape),
                         "of": 'PIL 12.1 convert("RGBA")'}
    return out


# the extensions the port writes byte for byte as PIL (JPEG, BMP, DIB,
# TIFF, PPM, TGA, GIF, IM, PCX, SGI and WebP, PIL 12.1's names for each);
# IM and SGI write the file's name, so every file is written as "x" +
# extension
WRITE_EXTENSIONS = (".jpg", ".jpeg", ".jpe", ".jfif", ".bmp", ".dib",
                    ".tif", ".tiff", ".pbm", ".pgm", ".ppm", ".pnm", ".pfm",
                    ".tga", ".icb", ".vda", ".vst", ".gif", ".im", ".pcx",
                    ".sgi", ".bw", ".rgb", ".rgba", ".webp")


def writer_images() -> dict:
    """{name: {"L": [H, W] uint8, "RGB": [H, W, 3] uint8}}: the 37x29
    fixture image (the content of ``small.bmp``) and a procedural
    3840x2160 one; L is the green channel."""
    ti = _images_module()
    h, w = SMALL
    out = {}
    for name, rgb in (("small_37x29", ti.smooth_rgb(9, w, h)),
                      ("procedural_3840x2160",
                       procedural_rgb(3840, 2160, 10))):
        out[name] = {"L": np.ascontiguousarray(rgb[..., 1]), "RGB": rgb}
    return out


def write_digests() -> dict:
    """{image: {mode: {extension: sha256 of PIL's file}}}."""
    import tempfile
    from PIL import Image
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, modes in writer_images().items():
            for mode, px in modes.items():
                for ext in WRITE_EXTENSIONS:
                    path = os.path.join(tmp, "x" + ext)
                    Image.fromarray(px).save(path)
                    with open(path, "rb") as f:
                        digest = hashlib.sha256(f.read()).hexdigest()
                    out.setdefault(name, {}).setdefault(mode, {})[ext] = \
                        digest
    return out


def fixtures():
    """{name: (file bytes, RGBA8 the port must decode, how it was got)}."""
    from PIL import Image
    ti = _images_module()
    rng = np.random.default_rng(9)
    h, w = SMALL
    small = ti.smooth_rgb(9, w, h)
    alpha = rng.integers(0, 256, (h, w, 1), np.uint8)
    alpha[:, :w // 2] = 255                       # runs for the RLE

    def pil_file(img, fmt, **save):
        out = io.BytesIO()
        img.save(out, fmt, **save)
        return out.getvalue()

    files = {
        "roughness_2048_prog420.jpg": ti.jpeg_bytes(
            roughness_map(), quality=90, progressive=True, subsampling=2),
        "normal_1024_444.jpg": ti.jpeg_bytes(
            normal_map(), quality=90, subsampling=0),
        "roughness_2048_ycck_arith_prog.jpg": ti.libjpeg_bytes(
            roughness_cmyk(), "ycck", arith=True, progressive=True,
            sampling=[(2, 2), (1, 1), (1, 1), (2, 2)], quality=75),
        # K stored as 255 (none, inverted), so RGB is the first three
        "normal_1024_cmyk_arith.jpg": ti.libjpeg_bytes(
            np.concatenate([normal_map(bumps=2),
                            np.full((1024, 1024, 1), 255, np.uint8)], -1),
            "cmyk", arith=True, sampling=[(1, 1)] * 4, restart=128,
            dac={0: (1, 4, 12)}, quality=75),
        "small_cmyk.jpg": pil_file(Image.fromarray(np.concatenate(
            [small, alpha], -1), "CMYK"), "JPEG"),
        "small_ycck_prog.jpg": ti.libjpeg_bytes(np.concatenate(
            [small, alpha], -1), "ycck", progressive=True),
        "small_grey_arith.jpg": ti.libjpeg_bytes(small[..., 1], "grey",
                                                 arith=True),
        "small.bmp": pil_file(Image.fromarray(small), "BMP"),
        "small.tga": pil_file(Image.fromarray(np.concatenate(
            [small, alpha], -1), "RGBA"), "TGA", compression="tga_rle"),
        "small.ppm": pil_file(Image.fromarray(small), "PPM"),
        "adam7.png": ti.png_bytes(small, 2, 8, interlace=1),
        "roughness_2048_deflate.tif": pil_file(
            Image.fromarray(roughness_map()[..., 0]), "TIFF",
            compression="tiff_adobe_deflate", tiffinfo={317: 2}),
        "normal_512_lzw16.tif": ti.tiff_bytes(
            normal_map16(), 16, compression=5, predictor=2,
            rows_per_strip=16),
        "interlaced.gif": ti.gif_bytes(
            (small[..., 0] // 16).astype(np.uint8),
            global_palette=ti.smooth_rgb(10, 16, 1)[0].tobytes(),
            interlace=True, transparency=3),
        "tiled_planar.tif": ti.tiff_bytes(small, compression=5,
                                          tile=(16, 16), planar=2),
        "rle.psd": ti.psd_bytes(np.moveaxis(np.concatenate(
            [small, alpha], -1), -1, 0), 3, rle=True),
        "assoc_alpha.tif": ti.tiff_bytes(
            np.concatenate([small // 2, alpha], -1), extra=[1],
            compression=32773),
        "roughness_2048_lossy.webp": ti.webp_bytes(roughness_map(),
                                                   quality=80),
        "normal_1024_lossless.webp": ti.webp_bytes(np.concatenate(
            [normal_map(), bump_height()], -1), lossless=True),
        "small_lossy.webp": ti.webp_bytes(small, quality=70),
        "small_lossy_alpha.webp": ti.webp_bytes(np.concatenate(
            [small, alpha], -1), quality=70, alpha_quality=60),
        "small_palette.webp": ti.webp_bytes(
            ti.smooth_rgb(10, 5, 1)[0][(small[..., 0] // 52).clip(0, 4)],
            lossless=True),
        "small_anim.webp": ti.webp_bytes(
            first_frame(small, alpha), quality=70, save_all=True,
            duration=100, append_images=[ti.webp_image(np.concatenate(
                [small, alpha], -1))]),
    }
    out = {}
    for name, data in files.items():
        out[name] = (data, ti.pil_rgba8(data), 'PIL 12.1 convert("RGBA")')
    grey = rng.integers(0, 1 << 16, (h, w, 1))
    high = np.full((h, w, 4), 255, np.uint8)
    high[..., :3] = (grey >> 8).astype(np.uint8)
    how = ("the high byte of each 16-bit sample (the port's named "
           "deviation: PIL clips mode I;16 at 255)")
    out["grey16.png"] = (ti.png_bytes(grey, 0, 16), high, how)
    out["grey16.tif"] = (ti.tiff_bytes(grey, 16), high, how)
    out["grey16.pgm"] = (pil_file(Image.frombytes(
        "I;16", (w, h), grey.astype("<u2").tobytes()), "PPM"), high, how)
    # PIL's JPEG TIFFs of four modes, 4:2:0 ones wrapped by hand, and
    # PIL's CCITT TIFFs of mode 1 (two in 8-row strips)
    bilevel = Image.fromarray(small[..., 0] > 120)
    files = {
        **{f"small_jpeg_{m.lower()}.tif": pil_file(
            Image.fromarray(small).convert(m), "TIFF", compression="jpeg")
           for m in ("L", "RGB", "YCbCr")},
        "small_jpeg_cmyk.tif": pil_file(Image.fromarray(np.concatenate(
            [small, alpha], -1), "CMYK"), "TIFF", compression="jpeg"),
        "small_jpeg420_strips.tif": ti.jpeg_tiff_bytes(
            small, 2, rows_per_strip=16),
        "small_jpeg420_tiles.tif": ti.jpeg_tiff_bytes(
            small, 2, tile=(16, 16), tables=True),
        "small_g3_1d.tif": pil_file(bilevel, "TIFF", compression="group3"),
        "small_g3_2d.tif": pil_file(bilevel, "TIFF", compression="group3",
                                    tiffinfo={292: 1, 278: 8}),
        "small_g3_eol_aligned.tif": pil_file(
            bilevel, "TIFF", compression="group3", tiffinfo={292: 4}),
        "small_g4_miniswhite.tif": pil_file(
            bilevel, "TIFF", compression="group4", tiffinfo={262: 0}),
        "small_g4_fill2.tif": pil_file(bilevel, "TIFF", compression="group4",
                                       tiffinfo={266: 2, 278: 8}),
        "small_ccitt_rle.tif": pil_file(bilevel, "TIFF",
                                        compression="tiff_ccitt"),
        "roughness_2048_g4.tif": pil_file(Image.fromarray(
            roughness_bilevel()), "TIFF", compression="group4"),
    }
    for name, data in files.items():
        out[name] = (data, ti.pil_rgba8(data), 'PIL 12.1 convert("RGBA")')
    # PIL's files of modes 1, F and I, and 16-bit and maxval-1000 P6 files
    # (PIL writes no P6 but at 255), from their own seed
    more = np.random.default_rng(17)
    wide = small.astype(np.int64) * 257 + more.integers(0, 257, (h, w, 3))
    files = {
        "small.pbm": pil_file(Image.fromarray(small[..., 0] > 120), "PPM"),
        "small.pfm": pil_file(Image.fromarray(
            (small[..., 1].astype(np.float32) * 1.25 - 30.5)), "PPM"),
        "small_1bit.tga": pil_file(Image.fromarray(small[..., 2] > 100),
                                   "TGA"),
        "small_i32_lzw.tif": pil_file(Image.fromarray(
            more.integers(-200, 700, (h, w)).astype(np.int32)), "TIFF",
            compression="tiff_lzw"),
        "small16.ppm": b"P6\n%d %d\n65535\n" % (w, h) + wide.astype(
            ">u2").tobytes(),
        "small_1000.ppm": b"P6\n%d %d\n1000\n" % (w, h) + (
            wide * 1000 // 65535).astype(">u2").tobytes(),
    }
    for name, data in files.items():
        out[name] = (data, ti.pil_rgba8(data), 'PIL 12.1 convert("RGBA")')
    return out


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    digests = {}
    for name, (data, rgba, how) in fixtures().items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        digests[name] = {"shape": list(rgba.shape), "rgba_sha256":
                         hashlib.sha256(rgba.tobytes()).hexdigest(),
                         "of": how}
        print(f"{name}: {len(data)} bytes, {rgba.shape[1]}x{rgba.shape[0]}")
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    with open(os.path.join(OUT, "write_digests.json"), "w") as f:
        json.dump(write_digests(), f, indent=1, sort_keys=True)
        f.write("\n")
    with open(os.path.join(OUT, "map_digests.json"), "w") as f:
        json.dump(reader_map_digests(), f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
