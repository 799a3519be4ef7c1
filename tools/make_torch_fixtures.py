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
byte for byte (a PDF under ``time.gmtime`` pinned to
:data:`PINNED_GMTIME` by :func:`pinned_gmtime`) and, for ICO and ICNS,
whose frames are PNG files the port deflates otherwise than PIL, the
:func:`icon_digest` of PIL's file; no image is committed for these.
``chip_smoke.py`` imports :func:`writer_images`, :func:`pinned_gmtime`
and :func:`file_digest` from this file (PIL is imported only where it is
used).

And it records, in ``tests/torch_data/map_digests.json``, the sha256 of
each of ``READER_MAPS`` (the textured sessions' RLE SGI roughness map and
PCX normal map, uncompressed CMYK roughness map and PackBits YCbCr
normal map as TIFFs, a JPEG-in-TIFF normal map in 256x256 tiles, a QOI
roughness map and a DXT1 DDS normal map, an ICNS roughness map and an ICO
normal map, a grey JP2 roughness map and a JPEG 2000 codestream normal
map, a BC6H roughness map and a BC7 normal map as DDS files, an FTEX
DXT1 roughness map and a BLP2 DXT5 normal map, a BLP1 JPEG normal map
and a BLP2 palette roughness map, made at run time by
:func:`reader_map`: nothing is committed;
for the ICNS and ICO maps its :func:`icon_digest`) and of PIL's decode of
it;
``chip_smoke.py`` holds the maps it builds and the port's decodes of
them to these. So it does, in ``tests/torch_data/raster_map_digests.json``,
with ``RASTER_MAPS`` (FITS at BITPIX 8, 16 and -32 and as GZIP_1 tiles,
a 2-byte McIDAS, a SPIDER, a PIXAR and a DCX file, made by
:func:`raster_map`; the 16-bit maps' digests are of the high-byte image
of the port's named deviation), and in
``tests/torch_data/bitmap_map_digests.json`` with ``BITMAP_MAPS`` (Sun
rasters at 8 bits run-length and 24 bits, a ``LinS`` MSP file, a GIMP
brush, an XBM and P and RGB XPMs, made by :func:`bitmap_map`).

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
  of ``chip_smoke.py``'s ``tiff-jpeg-ccitt`` turn);
- PIL's QOI of the 37x29 image with alpha (``small.qoi``: QOI_OP_RGBA,
  runs and every other op), its DXT5 DDS (``small_dxt5.dds``, PIL's BCn
  encoder) and its uncompressed RGBA DDS (``small_rgba.dds``, 32-bit
  pixels under ARGB masks);
- PIL's ICO of the 37x29 image with alpha (``small.ico``: PNG frames of
  16x13 and 24x19, PIL's LANCZOS thumbnails) and its ICNS of the top-left
  6x5 corner of the image as L (``small_6x5_grey.icns``: PNG entries of
  32 to 1024 pixels a side, PIL's BICUBIC resizes);
- PIL's JPEG 2000 files at its defaults: the 37x29 image with alpha as a
  JP2 file (``small_rgba.jp2``: a ``cdef`` box naming the alpha) and its
  green channel as a bare codestream (``small_grey.j2k``);
- 37x29 DX10 DDS files of hashed blocks: BC6H SF16 over every mode and
  reserved code, end points bounded so that most half floats fall in
  [-1, 1] (``small_bc6h_sf16.dds``), and BC7 over every mode and the
  reserved one under the sRGB name (``small_bc7_srgb.dds``);
- 37x29 BLP files: a BLP1 palette image of hashed indices and palette
  with the alpha flag (``small_palette.blp``), a BLP1 JPEG of
  ``small_ycck_prog.jpg`` (``small_ycck.blp``) and BLP2 DXT1 of hashed
  blocks without the alpha flag (``small_dxt1.blp``);
- PIL's JPEG 2000 files under its save options (``J2K_OPTION_FILES``): a
  19x13 file for each step of the reader beyond PIL's defaults
  (``small_layers_db.j2k``, ``small_rpcl_precincts.jp2``,
  ``small_tiles_offsets.j2k``, ``small_97_ict.jp2``, ``small_rct.j2k``,
  ``small_signed.jp2``), the ``j2k-lossy`` session's maps
  (``roughness_2048_97_layers.jp2``: grey, 9/7, three rate layers;
  ``normal_1024_97_ict_tiles.j2k``: RGB, 9/7 and ICT, 256x256 tiles at
  odd offsets, RPCL, 128x128 precincts, two layers) and
  ``icon_512_jp2_97.icns``, whose ``ic09`` entry is a 9/7 JP2;
- PIL's LZMA, ZSTD and two-channel JPEG TIFFs
  (:func:`tiff_compression_files`): the ``tiff-lzma-zstd`` session's maps
  (``roughness_2048_zstd.tif``: grey, ZSTD, predictor 2;
  ``normal_1024_lzma.tif``: RGB, LZMA), ``zstd_blocks_256.tif`` (a 192
  KiB strip in two ZSTD blocks) and 13x9 files: ``small_lzma_rgba.tif``,
  ``small_lzma_i.tif`` (32-bit predictor), ``small_zstd_la.tif``,
  ``small_zstd_f.tif`` and ``small_jpeg_la.tif``;
- the raw-decoder rasters at 13x9 (:func:`raster_files`):
  ``small_8.fits``, ``grey16.fits`` (its digest the high-byte image),
  ``small_f32.fits``, ``small_gzip.fits`` (GZIP_1), ``small.mcidas``,
  ``small.spider`` (PIL's), ``small.pxr``, ``small.imt``,
  ``small.xvthumb`` and ``small_two_pages.dcx``;
- the X11 and Sun bitmaps at 13x9 (:func:`bitmap_files`):
  ``small_rle.ras``, ``small_pal.ras``, ``small_24.ras``,
  ``small_32_rle.ras``, ``small_1.ras``, ``small_v1.gbr``,
  ``small_v2.gbr``, ``small.msp`` (PIL's), ``small_rle.msp``,
  ``small.xbm`` (PIL's) and ``small.xpm``;
- CIELab at 13x9 (:func:`cielab_files`): ``small_lab_lzw.tif`` (PIL's
  LZW TIFF of mode LAB) and ``small_lab_rle.psd`` (colour mode 9, RLE);
  and ``lab_2048_jpeg.tif`` (:func:`cielab_jpeg_map`, PIL's JPEG TIFF of
  mode LAB, one of ``CIELAB_MAPS``), whose digests, with the other
  ``CIELAB_MAPS`` and LittleCMS's own table, are
  ``cielab_map_digests.json``.

Run from the repository root: ``python3 tools/make_torch_fixtures.py``.
"""

import contextlib
import gzip
import hashlib
import importlib.util
import io
import json
import os
import struct
import sys
import time
import zlib

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


def bmp_rle8_bytes(index: np.ndarray, palette: np.ndarray = None) -> bytes:
    """A BMP file of [H, W] uint8 palette indices in RLE8 (compression 1),
    which neither PIL nor the port writes, row 0 the image's top; the
    palette [N, 3] uint8 RGB, or with None the 256 greys (PIL reads the
    file as mode L). Rows bottom-up, each its packets: a run of equal
    indices as its count (up to 255) and the index, a stretch of three or
    more indices between runs as an absolute run (``0``, its count, the
    indices, a byte of padding after an odd count), an end of line after
    each row and an end of bitmap after the last. The pixel data starts at
    an even offset, so the padding is also PIL's word alignment. In numpy
    over the whole image (no loop over runs)."""
    px = np.asarray(index, np.uint8)
    h, w = px.shape
    pal = (np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
           if palette is None else np.asarray(palette, np.uint8))
    v = px[::-1].ravel().astype(np.int64)
    start = np.ones(v.size, bool)
    start[1:] = v[1:] != v[:-1]
    start[::w] = True                         # a row starts a run
    pos = np.flatnonzero(start)
    length = np.diff(np.append(pos, v.size))
    single = length == 1
    same_row = np.zeros_like(single)
    same_row[1:] = pos[1:] // w == pos[:-1] // w
    # singles next to one another in a row join into a literal stretch,
    # where it holds three or more (absolute runs are 3 to 255 long)
    joins = np.zeros_like(single)
    joins[1:] = single[1:] & single[:-1] & same_row[1:]
    seg_id = np.cumsum(~joins) - 1
    seg_len = np.bincount(seg_id, weights=length).astype(np.int64)
    joins &= seg_len[seg_id] >= 3
    seg = ~joins
    seg_id = np.cumsum(seg) - 1
    seg_len = np.bincount(seg_id, weights=length).astype(np.int64)
    seg_pos, literal = pos[seg], single[seg] & (seg_len >= 3)
    # packets of at most 255 indices; a literal stretch's last one at
    # least 3 (it borrows from the one before)
    n_pk = (seg_len + 254) // 255
    first = np.cumsum(n_pk) - n_pk
    k = np.arange(n_pk.sum()) - np.repeat(first, n_pk)
    pk_start = np.repeat(seg_pos, n_pk) + 255 * k
    pk_count = np.minimum(np.repeat(seg_len, n_pk) - 255 * k, 255)
    pk_lit = np.repeat(literal, n_pk)
    short = pk_lit & (pk_count < 3)
    borrow = np.where(short, 3 - pk_count, 0)
    pk_count = pk_count + borrow
    pk_start = pk_start - borrow
    pk_count[np.flatnonzero(short) - 1] -= borrow[short]
    pk_row = pk_start // w
    size = np.where(pk_lit, 2 + pk_count + (pk_count & 1), 2)
    row_bytes = np.bincount(pk_row, weights=size, minlength=h).astype(
        np.int64) + 2
    row_at = np.cumsum(row_bytes) - row_bytes
    at = row_at[pk_row] + (np.cumsum(size) - size) - (
        np.cumsum(row_bytes - 2) - (row_bytes - 2))[pk_row]
    body = np.zeros(int(row_bytes.sum()), np.uint8)
    body[-1] = 1          # each row ends 00 00 (end of line), the last 00 01
    run = ~pk_lit
    body[at[run]] = pk_count[run]
    body[at[run] + 1] = v[pk_start[run]]
    body[at[pk_lit] + 1] = pk_count[pk_lit]
    lit_n = pk_count[pk_lit]
    off = np.arange(lit_n.sum()) - np.repeat(np.cumsum(lit_n) - lit_n, lit_n)
    body[np.repeat(at[pk_lit] + 2, lit_n) + off] = v[
        np.repeat(pk_start[pk_lit], lit_n) + off]
    quads = np.zeros((len(pal), 4), np.uint8)
    quads[:, :3] = pal[:, ::-1]               # BGRX
    offset = 14 + 40 + quads.size
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 8, 1, body.size, 0, 0,
                       len(pal), 0)
    return (b"BM" + struct.pack("<IHHI", offset + body.size, 0, 0, offset)
            + info + quads.tobytes() + body.tobytes())


def ico_dib_bytes(rgb: np.ndarray, transparent: np.ndarray) -> bytes:
    """A one-frame ICO file whose frame is a 24-bit DIB of [H, W, 3] uint8
    ``rgb`` (row 0 the top) with an AND mask of [H, W] bool
    ``transparent``: the directory entry (256 as 0), then the
    BITMAPINFOHEADER at the doubled height, the BGR rows bottom-up, each
    padded to 4 bytes, and the mask's rows bottom-up, a set bit
    transparent, each padded to 4 bytes."""
    h, w = rgb.shape[:2]
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = np.asarray(rgb, np.uint8)[::-1, :, ::-1].reshape(h, -1)
    mask_stride = (w + 31) // 32 * 4
    mask = np.zeros((h, mask_stride), np.uint8)
    bits = np.packbits(np.asarray(transparent, bool)[::-1], axis=1)
    mask[:, :bits.shape[1]] = bits
    dib = (struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, 24, 0,
                       rows.size + mask.size, 0, 0, 0, 0)
           + rows.tobytes() + mask.tobytes())
    return (b"\0\0\1\0\1\0" + struct.pack("<BBBBHHII", w % 256, h % 256, 0,
                                          0, 1, 24, len(dib), 22) + dib)


def cur_bytes(rgba: np.ndarray, hotspot=(0, 0)) -> bytes:
    """A one-entry CUR file of [H, W, 4] uint8 ``rgba`` (row 0 the top):
    the directory entry (its hotspot where an ICO entry has its planes and
    bits), then at byte 22 a 32-bit BITMAPINFOHEADER at the doubled
    height, the BGRA rows bottom-up and an AND mask of zeros (PIL reads a
    32-bit cursor at byte 22 with its alpha and no mask)."""
    h, w = rgba.shape[:2]
    px = np.asarray(rgba, np.uint8)[::-1][..., [2, 1, 0, 3]].tobytes()
    mask = bytes((w + 31) // 32 * 4 * h)
    dib = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, 32, 0,
                      len(px) + len(mask), 0, 0, 0, 0) + px + mask
    return (b"\0\0\2\0\1\0" + struct.pack("<BBBBHHII", w % 256, h % 256, 0,
                                          0, *hotspot, len(dib), 22) + dib)


def icns_rle(plane: np.ndarray) -> bytes:
    """One plane of an ICNS 24-bit RLE entry as IcnsImagePlugin's
    ``read_32`` reads it: a run of 3 to 130 equal bytes as ``count + 125``
    and the byte, the bytes between runs as literals of up to 128
    (``count - 1`` and the bytes)."""
    v = np.asarray(plane, np.uint8).ravel()
    start = np.ones(v.size, bool)
    start[1:] = v[1:] != v[:-1]
    pos = np.flatnonzero(start)
    length = np.diff(np.append(pos, v.size))
    out, lit = bytearray(), bytearray()
    for p, n in zip(pos.tolist(), length.tolist()):
        while n >= 3:
            if lit:
                for i in range(0, len(lit), 128):
                    out += bytes([len(lit[i:i + 128]) - 1]) + lit[i:i + 128]
                lit = bytearray()
            k = min(n, 130)
            out += bytes([k + 125, v[p]])
            p, n = p + k, n - k
        lit += v[p:p + n].tobytes()
    for i in range(0, len(lit), 128):
        out += bytes([len(lit[i:i + 128]) - 1]) + lit[i:i + 128]
    return bytes(out)


def icns_bytes(*blocks) -> bytes:
    """An ICNS file of ``(type, body)`` blocks behind PIL's table of
    contents."""
    def block(kind, body):
        return kind + struct.pack(">I", 8 + len(body)) + body
    body = b"".join(block(k, b) for k, b in blocks)
    body = block(b"TOC ", b"".join(block(k, b)[:8] for k, b in blocks)) + body
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


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
# integers only; a 2048x2048 RGB roughness map as the QOI file Image.save
# writes (which the port's writer writes byte for byte) and a 1024x1024
# DXT1 DDS normal map of hashed block bytes (dxt1_map_bytes); a 2048x2048
# RGB roughness map as an ICNS file (read at its 1024x1024 ic10 entry)
# and a 1024x1024 RGB normal map as an ICO file (read at its 256x256
# frame), written by Image.save or the port, held by icon_digest; a
# 2048x2048 grey roughness map (the green channel) as a JP2 file and a
# 1024x1024 RGB normal map as a JPEG 2000 codestream, written by
# Image.save or the port; the grey channel 0 of roughness_map(2048) as an
# RLE8 BMP (bmp_rle8_bytes) and normal_map(256) as an ICO of a 24-bit DIB
# with an AND mask that clears the corners (ico_dib_bytes), the
# rle-bmp-ico session's maps, and, decoded and timed only, a 3840x2160
# RLE8 BMP of procedural_rgb's green channel under a colour palette, a
# 256x256 32-bit one-entry CUR (cur_bytes), a 128x128 ICNS of it32 and
# t8mk entries (icns_rle) and a 512x512 ICNS whose ic09 entry is a JP2
# file, written by Image.save or the port; the bc7-bc6h session's BC6H
# UF16 roughness map of bounded end points over the 14 modes
# (bc6h_blocks) and BC7 normal map over the 8 modes (bc7_blocks) as DX10
# DDS files; the blp-ftex session's FTEX DXT1 roughness map and BLP2 DXT5
# normal map (with the alpha flag) of hashed blocks, a BLP1 JPEG of
# normal_map(512) (its JPEG split after the SOS segment) and a BLP2
# palette image with alpha (the number: the seed; None where the content
# is not procedural_rgb's)
READER_MAPS = {"roughness_2048_rle.sgi": (2048, 11),
               "roughness_2048.icns": (2048, 20),
               "normal_1024.ico": (1024, 21),
               "normal_1024.pcx": (1024, 12),
               "roughness_2048_cmyk.tif": (2048, 13),
               "normal_1024_ycbcr_packbits.tif": (1024, 14),
               "normal_1024_jpeg_tiles.tif": (1024, 16),
               "roughness_2048.qoi": (2048, 18),
               "normal_1024_dxt1.dds": (1024, 19),
               "roughness_2048_grey.jp2": (2048, 22),
               "normal_1024.j2k": (1024, 23),
               "roughness_2048_rle8.bmp": (2048, None),
               "normal_256_dib.ico": (256, None),
               "rle8_3840x2160.bmp": (3840, 24),
               "cursor_256.cur": (256, 26),
               "icon_128_it32.icns": (128, 28),
               "icon_512_jp2.icns": (512, 30),
               "roughness_2048_bc6h.dds": (2048, 32),
               "normal_1024_bc7.dds": (1024, 34),
               "roughness_2048_dxt1.ftc": (2048, 36),
               "normal_1024_dxt5.blp": (1024, 38),
               "normal_512_jpeg.blp": (512, None),
               "roughness_512_palette.blp": (512, 40)}


def dds_header(width: int, height: int, pfflags: int, fourcc: bytes = b"",
               bitcount: int = 0, masks=(0, 0, 0, 0), dxgi=None) -> bytes:
    """A DDS file's 128-byte header (and, with ``dxgi``, the 20-byte DX10
    header after it) as DdsImagePlugin reads it: flags CAPS, HEIGHT,
    WIDTH and PIXELFORMAT, the pixel format's flags, fourcc, bit count
    and four masks, DDSCAPS TEXTURE."""
    head = (b"DDS " + struct.pack("<7I", 124, 0x1007, height, width, 0, 0,
                                  0) + bytes(44)
            + struct.pack("<II4sI", 32, pfflags, fourcc.ljust(4, b"\0"),
                          bitcount) + struct.pack("<4I", *masks)
            + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 0, 1)
    return head


def dxt1_map_bytes(n: int, seed: int) -> bytes:
    """An ``n``-square DXT1 DDS file (``n`` a multiple of 4) whose 8-byte
    blocks are hashed integers (both colour orders, so both of BC1's
    modes), after :func:`dds_header`."""
    k = np.arange(n * n // 2, dtype=np.uint64)
    hsh = (k * 2654435761 + seed * 40503) & 0xFFFFFFFF
    hsh = ((hsh ^ (hsh >> 15)) * 2246822519) & 0xFFFFFFFF
    return (dds_header(n, n, 0x4, b"DXT1")
            + ((hsh ^ (hsh >> 13)) & 0xFF).astype(np.uint8).tobytes())


M32 = 0xFFFFFFFF


def hashed_bytes(n: int, seed: int) -> np.ndarray:
    """[n] uint8 of a multiplicative integer hash of each index and
    ``seed`` (the same on every machine and numpy: no generator); the seed
    is mixed in twice, so that two seeds' streams are not one stream
    shifted."""
    m = np.uint64(M32)
    k = np.arange(n, dtype=np.uint64)
    h = (k * np.uint64(2654435761) + np.uint64((seed * 40503 + 7) & M32)) & m
    h = ((h ^ (h >> np.uint64(15))) * np.uint64(2246822519)) & m
    h ^= np.uint64((seed * 0x85EBCA6B) & M32)
    h = ((h ^ (h >> np.uint64(13))) * np.uint64(3266489917)) & m
    return ((h ^ (h >> np.uint64(16))) & np.uint64(0xFF)).astype(np.uint8)


def _hashed_u32(n: int, seed: int) -> np.ndarray:
    """[n] int64 of 32 hashed bits each (four :func:`hashed_bytes`)."""
    b = hashed_bytes(4 * n, seed).reshape(n, 4).astype(np.int64)
    return b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24


def bc7_blocks(count: int, seed: int, modes=range(8)) -> np.ndarray:
    """[count, 16] uint8 BC7 blocks of hashed bytes, block i forced to mode
    ``modes[i % len(modes)]`` (its lowest set bit of byte 0; the reserved
    mode 8 makes byte 0 zero). Uniform bytes would be mode 0 half the time
    and mode 7 once in 256."""
    blocks = hashed_bytes(16 * count, seed).reshape(count, 16)
    modes = np.asarray(list(modes), np.int64)
    mode = modes[np.arange(count) % len(modes)]
    keep = (0xFF << (mode + 1)) & 0xFF
    blocks[:, 0] = np.where(mode > 7, 0,
                            (blocks[:, 0] & keep) | (1 << np.minimum(mode, 7)))
    return blocks


# BC6H's 5-bit mode codes of its 14 modes, the first two 2-bit, and the
# four reserved ones (PIL decodes them as black)
BC6H_CODES = (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15)
BC6H_RESERVED = (19, 23, 27, 31)
# each mode's (end-point bits, transformed, delta bits R, G, B), and the
# order of its end-point bits after the mode code, as the D3D BC6H
# specification's table lists them (w, x, y, z: the end points r0/g0/b0,
# r1, r2, r3; "rw11-10" is bit 11 then bit 10)
BC6H_MODES = ((10, 1, 5, 5, 5), (7, 1, 6, 6, 6), (11, 1, 5, 4, 4),
              (11, 1, 4, 5, 4), (11, 1, 4, 4, 5), (9, 1, 5, 5, 5),
              (8, 1, 6, 5, 5), (8, 1, 5, 6, 5), (8, 1, 5, 5, 6),
              (6, 0, 6, 6, 6), (10, 0, 10, 10, 10), (11, 1, 9, 9, 9),
              (12, 1, 8, 8, 8), (16, 1, 4, 4, 4))
_BC6H_LAYOUTS = (
    "gy4 by4 bz4 rw0-9 gw0-9 bw0-9 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 bx0-4 "
    "bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    "gy5 gz4 gz5 rw0-6 bz0 bz1 by4 gw0-6 by5 bz2 gy4 bw0-6 bz3 bz5 bz4 "
    "rx0-5 gy0-3 gx0-5 gz0-3 bx0-5 by0-3 ry0-5 rz0-5",
    "rw0-9 gw0-9 bw0-9 rx0-4 rw10 gy0-3 gx0-3 gw10 bz0 gz0-3 bx0-3 bw10 "
    "bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    "rw0-9 gw0-9 bw0-9 rx0-3 rw10 gz4 gy0-3 gx0-4 gw10 gz0-3 bx0-3 bw10 "
    "bz1 by0-3 ry0-3 bz0 bz2 rz0-3 gy4 bz3",
    "rw0-9 gw0-9 bw0-9 rx0-3 rw10 by4 gy0-3 gx0-3 gw10 bz0 gz0-3 bx0-4 "
    "bw10 by0-3 ry0-3 bz1 bz2 rz0-3 bz4 bz3",
    "rw0-8 by4 gw0-8 gy4 bw0-8 bz4 rx0-4 gz4 gy0-3 gx0-4 bz0 gz0-3 bx0-4 "
    "bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    "rw0-7 gz4 by4 gw0-7 bz2 gy4 bw0-7 bz3 bz4 rx0-5 gy0-3 gx0-4 bz0 "
    "gz0-3 bx0-4 bz1 by0-3 ry0-5 rz0-5",
    "rw0-7 bz0 by4 gw0-7 gy5 gy4 bw0-7 gz5 bz4 rx0-4 gz4 gy0-3 gx0-5 "
    "gz0-3 bx0-4 bz1 by0-3 ry0-4 bz2 rz0-4 bz3",
    "rw0-7 bz1 by4 gw0-7 by5 gy4 bw0-7 bz5 bz4 rx0-4 gz4 gy0-3 gx0-4 bz0 "
    "gz0-3 bx0-5 by0-3 ry0-4 bz2 rz0-4 bz3",
    "rw0-5 gz4 bz0 bz1 by4 gw0-5 gy5 by5 bz2 gy4 bw0-5 gz5 bz3 bz5 bz4 "
    "rx0-5 gy0-3 gx0-5 gz0-3 bx0-5 by0-3 ry0-5 rz0-5",
    "rw0-9 gw0-9 bw0-9 rx0-9 gx0-9 bx0-9",
    "rw0-9 gw0-9 bw0-9 rx0-8 rw10 gx0-8 gw10 bx0-8 bw10",
    "rw0-9 gw0-9 bw0-9 rx0-7 rw11-10 gx0-7 gw11-10 bx0-7 bw11-10",
    "rw0-9 gw0-9 bw0-9 rx0-3 rw15-10 gx0-3 gw15-10 bx0-3 bw15-10")


def _bc6h_layout(text: str) -> "list[tuple[int, int]]":
    """[(end-point field 0-11, bit)] of one mode, in the block's order."""
    fields = {f"{c}{e}": 3 * i + j for i, e in enumerate("wxyz")
              for j, c in enumerate("rgb")}
    out = []
    for tok in text.split():
        lo, _, hi = tok[2:].partition("-")
        a, b = int(lo), int(hi or lo)
        out += [(fields[tok[:2]], k)
                for k in range(a, b + (1 if b >= a else -1),
                               1 if b >= a else -1)]
    return out


def bc6h_blocks(count: int, seed: int, signed: bool = False,
                bounded: bool = True, codes=BC6H_CODES) -> np.ndarray:
    """[count, 16] uint8 BC6H blocks, block i under the mode code
    ``codes[i % len(codes)]``, the partition and weights hashed. With
    ``bounded`` the end points are hashed within 0.48 of the mode's range
    (and, ``signed``, as far below 0), transformed ones as deltas within
    that range, so that most unquantised values are half floats in
    [0, 1] and the 8-bit step is exercised; else every bit is hashed
    (random end points mostly saturate)."""
    blocks = hashed_bytes(16 * count, seed).reshape(count, 16)
    bits = np.unpackbits(blocks, axis=1, bitorder="little")
    codes = np.asarray(list(codes), np.int64)
    code = codes[np.arange(count) % len(codes)]
    for c in np.unique(code):
        sel = np.nonzero(code == c)[0]
        nbits = 2 if c < 2 else 5
        for k in range(nbits):
            bits[sel, k] = (c >> k) & 1
        if not bounded or c not in BC6H_CODES:
            continue
        mode = BC6H_CODES.index(int(c))
        prec, tr, *dbits = BC6H_MODES[mode]
        lim = int(0.48 * (1 << (prec - 1 if signed else prec)))
        lo = -lim if signed else 0
        h = _hashed_u32(12 * sel.size, seed * 131 + int(c)).reshape(
            sel.size, 12)
        fields = lo + h % (lim - lo + 1)
        if tr:  # the deltas that keep each end point in [lo, lim]
            for i in range(3, 12):
                half = 1 << (dbits[i % 3] - 1)
                base = fields[:, i % 3]
                dlo = np.maximum(-half, lo - base)
                dhi = np.minimum(half - 1, lim - base)
                fields[:, i] = dlo + h[:, i] % (dhi - dlo + 1)
        for i in range(12):
            width = dbits[i % 3] if tr and i >= 3 else prec
            fields[:, i] &= (1 << width) - 1
        for k, (f, b) in enumerate(_bc6h_layout(_BC6H_LAYOUTS[mode])):
            bits[sel, nbits + k] = (fields[:, f] >> b) & 1
    return np.packbits(bits, axis=1, bitorder="little")


def bcn_dds_bytes(blocks: np.ndarray, width: int, height: int,
                  dxgi: int) -> bytes:
    """A DDS file of ``blocks`` ([N, 16] uint8, at least the image's)
    behind a DX10 header of DXGI format ``dxgi`` (:func:`dds_header`)."""
    return (dds_header(width, height, 0x4, b"DX10", dxgi=dxgi)
            + np.ascontiguousarray(blocks).tobytes())


def blp2_bytes(width: int, height: int, payload: bytes, encoding: int = 2,
               alpha: int = 1, alpha_encoding: int = 0,
               palette: bytes = bytes(1024), compression: int = 1,
               offset: "int | None" = None,
               length: "int | None" = None) -> bytes:
    """A BLP2 file as BlpImagePlugin reads it: the 20-byte header (signed
    bytes for the encoding, the alpha flag and the alpha encoding; no
    mipmaps), the first of the 16 mipmap offsets and lengths (by default
    where ``payload`` starts and its length), the 1,024-byte BGRA palette
    (padded with zeros), then ``payload``."""
    head = (b"BLP2" + struct.pack("<i4b2I", compression, encoding, alpha,
                                  alpha_encoding, 0, width, height))
    offset = 20 + 128 + 1024 if offset is None else offset
    length = len(payload) if length is None else length
    return (head + struct.pack("<16I", offset, *bytes(15))
            + struct.pack("<16I", length, *bytes(15))
            + palette.ljust(1024, b"\0") + payload)


def blp1_bytes(width: int, height: int, payload: bytes,
               compression: int = 1, encoding: int = 5, alpha: int = 0,
               palette: bytes = bytes(1024), jpeg_header: bytes = b"",
               offset: "int | None" = None,
               length: "int | None" = None) -> bytes:
    """A BLP1 file: the 28-byte header (subtype 0), the first of the 16
    mipmap offsets and lengths (by default where ``payload`` starts and
    its length), then for compression 0 (JPEG) the 4-byte size of
    ``jpeg_header`` and its bytes, else the 1,024-byte BGRA palette, then
    ``payload``."""
    head = (b"BLP1" + struct.pack("<iI2I2i", compression, alpha, width,
                                  height, encoding, 0))
    body = (struct.pack("<I", len(jpeg_header)) + jpeg_header
            if compression == 0 else palette.ljust(1024, b"\0"))
    offset = 28 + 128 + len(body) if offset is None else offset
    length = len(payload) if length is None else length
    return (head + struct.pack("<16I", offset, *bytes(15))
            + struct.pack("<16I", length, *bytes(15)) + body + payload)


def jpeg_sos_end(data: bytes) -> int:
    """Where a JPEG file's first SOS segment ends (its entropy-coded data
    starts): a BLP1 file keeps the bytes before it as its JPEG header."""
    pos = 2
    while True:
        marker, length = data[pos + 1], struct.unpack_from(">H", data,
                                                            pos + 2)[0]
        pos += 2 + length
        if marker == 0xDA:
            return pos


def blp1_jpeg_bytes(width: int, height: int, jpg: bytes,
                    alpha: int = 0) -> bytes:
    """A BLP1 JPEG file of the JPEG file ``jpg``, split as Blizzard's files
    are: the header up to the end of its first SOS segment, the rest the
    first mipmap."""
    split = jpeg_sos_end(jpg)
    return blp1_bytes(width, height, jpg[split:], compression=0,
                      alpha=alpha, jpeg_header=jpg[:split])


def ftex_bytes(width: int, height: int, fmt: int, payload: bytes,
               formats: int = 1, where: "int | None" = None,
               length: "int | None" = None) -> bytes:
    """An FTEX file as FtexImagePlugin reads it: ``FTEX``, version 0, the
    size, one mipmap and ``formats`` formats, the format (0 DXT1, 1 raw
    RGB) and the offset of the mipmap (by default right after), then at
    that offset the mipmap's length (by default the payload's) and
    ``payload``."""
    head = b"FTEX" + struct.pack("<5i", 0, width, height, 1, formats)
    where = len(head) + 8 if where is None else where
    length = len(payload) if length is None else length
    return (head + struct.pack("<2i", fmt, where)
            + struct.pack("<i", length) + payload)


# ---- the raw-decoder rasters: FITS, McIDAS, SPIDER, PIXAR, IMT, XV, DCX ----

def fits_card(key: str, value=None) -> bytes:
    """An 80-byte FITS header card: ``key`` alone (``END``, a comment) or
    ``key = value`` in the fixed format: a logical (``True``/``False``)
    or a number right-justified to column 30, a string quoted from column
    11 and padded inside its quotes to 8 characters."""
    if value is None:
        text = key
    elif isinstance(value, bool):
        text = f"{key:<8}= {'T' if value else 'F':>20}"
    elif isinstance(value, str):
        text = f"{key:<8}= '{value:<8}'"
    else:
        text = f"{key:<8}= {value:>20}"
    return text.ljust(80).encode("latin-1")[:80]


def fits_header(cards) -> bytes:
    """The cards (``(key, value)`` pairs, or ready 80-byte cards) and
    ``END``, padded with spaces to a multiple of 2,880 bytes."""
    out = b"".join(c if isinstance(c, bytes) else fits_card(*c)
                   for c in cards) + fits_card("END")
    return out + b" " * (-len(out) % 2880)


# BITPIX -> the sample's type (FITS stores big-endian)
FITS_TYPES = {8: "u1", 16: "i2", 32: "i4", -32: "f4", -64: "f8"}


def fits_bytes(samples: np.ndarray, bitpix: int, extra=(), order: str = ">",
               pad: bool = True) -> bytes:
    """A FITS file of one primary HDU holding ``samples`` ([n], [h, w] or
    [planes, h, w], in the file's order: FITS's first row is the image's
    bottom) at ``bitpix``, big-endian as the standard says (``order``
    "<": little-endian, as PIL reads them), the ``extra`` cards after the
    axes, the data padded with zeros to 2,880 bytes where ``pad``."""
    a = np.asarray(samples)
    cards = [("SIMPLE", True), ("BITPIX", bitpix), ("NAXIS", a.ndim)]
    cards += [(f"NAXIS{i + 1}", n) for i, n in enumerate(a.shape[::-1])]
    data = a.astype(order + FITS_TYPES[bitpix]).tobytes()
    if pad:
        data += bytes(-len(data) % 2880)
    return fits_header(cards + list(extra)) + data


def gzip_stored(raw: bytes) -> bytes:
    """A gzip member of deflate's stored blocks (no compression): the same
    bytes on every machine, whatever its zlib."""
    blocks = [raw[i:i + 65535] for i in range(0, len(raw), 65535)] or [b""]
    body = b"".join(bytes([i == len(blocks) - 1]) + struct.pack(
        "<HH", len(b), len(b) ^ 0xFFFF) + b for i, b in enumerate(blocks))
    return (b"\x1f\x8b\x08\x00" + bytes(4) + b"\x00\xff" + body
            + struct.pack("<II", zlib.crc32(raw), len(raw) & 0xFFFFFFFF))


def fits_gzip_bytes(rows: np.ndarray, zbitpix: int, sample_bytes: int = 4,
                    stored: bool = False, cmptype: str = "GZIP_1",
                    pad: bool = True) -> bytes:
    """A tile-compressed FITS image (the FITS tiled-image convention): an
    empty primary HDU, then a ``BINTABLE`` with ``ZIMAGE = T`` of one tile
    a row (``ZTILE1`` the width, ``ZTILE2`` 1), each tile's samples
    (``rows`` [h, w] integers, in the file's order) big-endian integers of
    ``sample_bytes`` bytes (4: the layout PIL's ``FitsGzipDecoder`` reads;
    ``zbitpix // 8``: each sample at its own size) in a gzip member in the
    heap (``stored``: :func:`gzip_stored`, else ``gzip`` at level 9), the
    table's descriptors (``1PB``: count and heap offset) before it."""
    h, w = rows.shape
    members = []
    for r in np.asarray(rows):
        raw = r.astype(f">i{sample_bytes}" if sample_bytes > 1 else
                       "u1").tobytes()
        members.append(gzip_stored(raw) if stored else
                       gzip.compress(raw, 9, mtime=0))
    at = np.cumsum([0] + [len(m) for m in members])
    table = b"".join(struct.pack(">2i", len(m), at[i])
                     for i, m in enumerate(members))
    heap = b"".join(members)
    cards = [("XTENSION", "BINTABLE"), ("BITPIX", 8), ("NAXIS", 2),
             ("NAXIS1", 8), ("NAXIS2", h), ("PCOUNT", len(heap)),
             ("GCOUNT", 1), ("TFIELDS", 1), ("TTYPE1", "COMPRESSED_DATA"),
             ("TFORM1", f"1PB({max(len(m) for m in members)})"),
             ("ZIMAGE", True), ("ZTILE1", w), ("ZTILE2", 1),
             ("ZCMPTYPE", cmptype), ("ZBITPIX", zbitpix), ("ZNAXIS", 2),
             ("ZNAXIS1", w), ("ZNAXIS2", h)]
    data = table + heap
    if pad:
        data += bytes(-len(data) % 2880)
    return (fits_header([("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0),
                         ("EXTEND", True)]) + fits_header(cards) + data)


def mcidas_bytes(lines: np.ndarray, nbytes: int, prefix: int = 0,
                 bands: int = 1, words=None) -> bytes:
    """A McIDAS AREA file: the 64 big-endian words of its directory
    (word 2 the version, 4; 9 and 10 the lines and elements, 11 the bytes
    an element, 14 the bands, 15 the line prefix's bytes, 34 the data's
    offset, 256: in PIL's numbering from 1), then each line's ``prefix``
    bytes (a hashed pattern) and its ``bands`` x width samples
    (``lines`` [h, w * bands], big-endian at ``nbytes``); ``words``
    ({number: value}) replaces any word."""
    h, n = lines.shape
    w = [0] * 65
    w[2], w[9], w[10], w[11], w[14], w[15], w[34] = (
        4, h, n // bands, nbytes, bands, prefix, 256)
    for k, v in (words or {}).items():
        w[k] = v
    body = np.asarray(lines).astype(f">u{nbytes}").view(np.uint8).reshape(
        h, -1)
    if prefix:
        body = np.concatenate([hashed_bytes(h * prefix, 50).reshape(
            h, prefix), body], 1)
    return struct.pack(">64i", *w[1:]) + body.tobytes()


def spider_bytes(image: np.ndarray, order: str = "<",
                 stack: int = 0) -> bytes:
    """A SPIDER file of ``image`` ([h, w] float32) as PIL's writer lays it
    out (``makeSpiderHeader``: a header of whole records of the row's
    length, at least 1,024 bytes), in byte order ``order`` (PIL writes
    its host's, little-endian here); with ``stack`` > 0 a stack: a
    header whose ``istack`` is ``stack`` and ``maxim`` 1, then the image's
    own header (``imgnum`` 1) and samples."""
    h, w = image.shape
    lenbyt = w * 4
    labrec = -(-1024 // lenbyt)
    labbyt = labrec * lenbyt

    def header(istack=0, maxim=0, imgnum=0):
        hdr = [0.0] * (labbyt // 4 + 1)
        hdr[1], hdr[2], hdr[3], hdr[5], hdr[12] = 1.0, h, h, 1.0, w
        hdr[13], hdr[22], hdr[23] = labrec, labbyt, lenbyt
        hdr[24], hdr[26], hdr[27] = istack, maxim, imgnum
        return struct.pack(f"{order}{len(hdr) - 1}f", *hdr[1:])

    data = np.asarray(image).astype(order + "f4").tobytes()
    if stack:
        return header(stack, 1) + header(imgnum=1) + data
    return header() + data


def pixar_bytes(rgb: np.ndarray, mode=(14, 2)) -> bytes:
    """A PIXAR file as PixarImagePlugin reads it: the magic, the height
    and width (little-endian) at bytes 416 and 418, the channel and depth
    description at 424 and 426, RGB from byte 1,024."""
    h, w = rgb.shape[:2]
    head = bytearray(1024)
    head[:4] = b"\x80\xe8\x00\x00"
    struct.pack_into("<2H", head, 416, h, w)
    struct.pack_into("<2H", head, 424, *mode)
    return bytes(head) + np.ascontiguousarray(rgb, np.uint8).tobytes()


def imt_bytes(grey: np.ndarray, comments=()) -> bytes:
    """An IM Tools file: ``*`` comment lines, ``width``, ``height`` and
    ``pixel n8`` lines, a form feed, the grey bytes."""
    h, w = grey.shape
    head = b"".join(b"*" + c + b"\n" for c in comments)
    head += b"width %d\nheight %d\npixel n8\n\x0c" % (w, h)
    return head + np.ascontiguousarray(grey, np.uint8).tobytes()


def xvthumb_bytes(index: np.ndarray, comments=(
        b"#XVVERSION:Version 3.10a  Rev: 12/29/94",
        b"#IMGINFO:512x512 RGB (roughness)", b"#END_OF_COMMENTS")) -> bytes:
    """An XV thumbnail: ``P7 332``, the comment lines, the size line,
    the 3-3-2 palette indices."""
    h, w = index.shape
    return (b"P7 332\n" + b"".join(c + b"\n" for c in comments)
            + b"%d %d 255\n" % (w, h)
            + np.ascontiguousarray(index, np.uint8).tobytes())


def dcx_bytes(pages, full: bool = False) -> bytes:
    """A DCX file of the PCX files ``pages``: the magic, the pages'
    offsets and a 0 (``full``: all 1,024 offsets, zeros after the pages',
    and the 0), the pages."""
    n = 1024 if full else len(pages)
    at = 4 + 4 * (n + 1)
    offsets = []
    for page in pages:
        offsets.append(at)
        at += len(page)
    offsets += [0] * (n + 1 - len(offsets))
    return (struct.pack("<I", 0x3ADE68B1) + struct.pack(f"<{n + 1}I",
                                                         *offsets)
            + b"".join(pages))


def pil_pcx(px: np.ndarray) -> bytes:
    """PIL's PCX of ``px`` (the port's ``write_image`` writes the same
    file)."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "PCX")
    return buf.getvalue()


def pil_jpeg(px: np.ndarray) -> bytes:
    """PIL's JPEG of ``px`` at its defaults (the port's ``jpeg.encode`` is
    the same file)."""
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "JPEG")
    return buf.getvalue()


def reader_map(name: str, jp2=None,
               jpg=None) -> "tuple[np.ndarray | None, bytes | None]":
    """(RGB pixels, file bytes) of one of ``READER_MAPS``: the RLE SGI
    file's bytes from :func:`sgi_rle_bytes`; None for the PCX, the QOI,
    the ICNS, the ICO and the JPEG 2000 maps (the JP2 one of the green
    channel), which the writer under test (PIL's or the port's
    ``write_image``) makes; for the TIFFs, whose samples are CMYK and YCbCr or JPEG
    streams, and the DDS, whose blocks are hashed bytes, no RGB pixels
    and the bytes of :func:`tiff_map_bytes`, :func:`jpeg_tiff_map_bytes`
    or :func:`dxt1_map_bytes`; for the RLE8 BMPs, the DIB-framed ICO, the
    CUR and the ICNS files, the pixels' RGB and the bytes of their
    encoders, the JP2 entry by ``jp2`` (a writer: [H, W, 3] uint8 to a
    JP2 file's bytes, PIL's or the port's); for the BC6H and BC7 DDS
    files, whose blocks are hashed, no RGB pixels and the bytes of
    :func:`bcn_dds_bytes`; for the BLP and FTEX files of hashed blocks
    and the BLP1 JPEG, whose JPEG is ``jpg``'s (a writer: [H, W, 3] uint8
    to a JPEG file's bytes, by default :func:`pil_jpeg`), no RGB pixels,
    for the BLP2 palette image its RGB, and the bytes of
    :func:`ftex_bytes`, :func:`blp2_bytes` or :func:`blp1_jpeg_bytes`."""
    n, seed = READER_MAPS[name]
    if name == "normal_512_jpeg.blp":
        return None, blp1_jpeg_bytes(n, n, (jpg or pil_jpeg)(normal_map(n)))
    if name.endswith("_dxt1.ftc"):
        return None, ftex_bytes(n, n, 0, hashed_bytes(n * n // 2,
                                                      seed).tobytes())
    if name.endswith("_dxt5.blp"):
        return None, blp2_bytes(n, n, hashed_bytes(n * n, seed).tobytes(),
                                alpha_encoding=7)
    if name.endswith("_palette.blp"):
        index = procedural_rgb(n, n, seed)[..., 1]
        rgba = np.concatenate([procedural_rgb(256, 1, seed + 1)[0],
                               procedural_rgb(256, 1, seed + 2)[0, :, :1]],
                              -1)
        return rgba[index, :3], blp2_bytes(
            n, n, index.tobytes(), encoding=1,
            palette=rgba[:, [2, 1, 0, 3]].tobytes())
    if name == "roughness_2048_rle8.bmp":
        grey = np.ascontiguousarray(roughness_map(n)[..., 0])
        return np.repeat(grey[..., None], 3, 2), bmp_rle8_bytes(grey)
    if name == "normal_256_dib.ico":
        px = normal_map(n)
        y, x = np.mgrid[0:n, 0:n] * 2 - (n - 1)
        return px, ico_dib_bytes(px, x * x + y * y > n * n)
    if name.endswith(".bmp"):
        index = procedural_rgb(n, n * 9 // 16, seed)[..., 1]
        palette = procedural_rgb(256, 1, seed + 1)[0]
        return palette[index], bmp_rle8_bytes(index, palette)
    px = procedural_rgb(n, n, seed)
    if name.endswith(".cur"):
        alpha = procedural_rgb(n, n, seed + 1)[..., :1]
        return px, cur_bytes(np.concatenate([px, alpha], -1), (n // 2, 3))
    if name.endswith("_it32.icns"):
        mask = procedural_rgb(n, n, seed + 1)[..., 0]
        rle = b"".join(icns_rle(px[..., c]) for c in range(3))
        return px, icns_bytes((b"it32", bytes(4) + rle),
                              (b"t8mk", mask.tobytes()))
    if name.endswith("_jp2.icns"):
        return px, icns_bytes((b"ic09", jp2(px)))
    if name.endswith(".sgi"):
        return px, sgi_rle_bytes(px, name=b"roughness")
    if name.endswith("_cmyk.tif"):
        return None, tiff_map_bytes(cmyk_of(px), 5)
    if name.endswith("_ycbcr_packbits.tif"):
        return None, tiff_map_bytes(ycbcr_of(px), 6, packbits=True)
    if name.endswith("_jpeg_tiles.tif"):
        return None, jpeg_tiff_map_bytes(px)
    if name.endswith("_dxt1.dds"):
        return None, dxt1_map_bytes(n, seed)
    if name.endswith("_bc6h.dds"):
        return None, bcn_dds_bytes(bc6h_blocks(n * n // 16, seed), n, n, 95)
    if name.endswith("_bc7.dds"):
        return None, bcn_dds_bytes(bc7_blocks(n * n // 16, seed), n, n, 98)
    if name.endswith("_grey.jp2"):
        return np.ascontiguousarray(px[..., 1]), None
    return px, None


def reader_map_digests() -> dict:
    """{map: {"file_sha256", "rgba_sha256", "shape", "of"}}: the
    :func:`file_digest` of each map's file (the RLE SGI encoder's output,
    PIL's PCX file, ...) and the sha256 of PIL's ``convert("RGBA")`` of
    it."""
    import tempfile
    from PIL import Image
    ti = _images_module()
    out = {}

    def jp2(px):
        buf = io.BytesIO()
        Image.fromarray(px).save(buf, "JPEG2000")
        return buf.getvalue()

    with tempfile.TemporaryDirectory() as tmp:
        for name in READER_MAPS:
            px, data = reader_map(name, jp2)
            if data is None:
                path = os.path.join(tmp, name)
                Image.fromarray(px).save(path)
                with open(path, "rb") as f:
                    data = f.read()
            rgba = ti.pil_rgba8(data)
            out[name] = {"file_sha256": file_digest(name, data,
                                                    ti.pil_rgba8),
                         "rgba_sha256": hashlib.sha256(
                             rgba.tobytes()).hexdigest(),
                         "shape": list(rgba.shape),
                         "of": 'PIL 12.1 convert("RGBA")'}
    return out


# the extensions the port writes as PIL (JPEG, BMP, DIB, TIFF, PPM, TGA,
# GIF, IM, PCX, SGI, WebP, QOI, DDS, EPS, MPO, PDF and JPEG 2000 (a
# codestream for ".j2k", else a JP2 file) byte for byte, PIL
# 12.1's names for each; ICO and ICNS frame for frame, ICON_EXTENSIONS);
# IM, SGI and PDF write the file's name, so every file is written as "x"
# + extension
WRITE_EXTENSIONS = (".jpg", ".jpeg", ".jpe", ".jfif", ".bmp", ".dib",
                    ".tif", ".tiff", ".pbm", ".pgm", ".ppm", ".pnm", ".pfm",
                    ".tga", ".icb", ".vda", ".vst", ".gif", ".im", ".pcx",
                    ".sgi", ".bw", ".rgb", ".rgba", ".webp", ".qoi", ".dds",
                    ".eps", ".ps", ".mpo", ".pdf", ".ico", ".icns", ".j2c",
                    ".j2k", ".jp2", ".jpc", ".jpf", ".jpx")
# what write_digests records where PIL raises (QOI of mode L) in place of
# the digest: the exception's type and message
QOI_L_RAISES = "ValueError: Unsupported QOI image mode"
# the extensions whose files are held by icon_digest, but for the reader
# maps made by an encoder here, whose bytes are held (ENCODED_ICONS)
ICON_EXTENSIONS = (".ico", ".icns")
ENCODED_ICONS = ("normal_256_dib.ico", "icon_128_it32.icns",
                 "icon_512_jp2.icns")
# what time.gmtime() gives while a PDF is written for a digest
PINNED_GMTIME = time.struct_time((2026, 1, 2, 3, 4, 5, 4, 2, 0))


@contextlib.contextmanager
def pinned_gmtime():
    """``time.gmtime()`` pinned to :data:`PINNED_GMTIME` (PIL's PDF writer
    and the port's read it for the dates the file holds)."""
    real = time.gmtime
    time.gmtime = lambda *args: PINNED_GMTIME
    try:
        yield
    finally:
        time.gmtime = real


def icon_digest(data: bytes, png_rgba) -> str:
    """The sha256 of an ICO or ICNS file's directory with its lengths and
    offsets left out (ICO: the header and each entry's size, colours,
    planes and bits; ICNS: the magic and each block's type, the table of
    contents' types), then of each frame's PNG signature and IHDR type,
    size, bit depth and colour type and of its pixels as ``png_rgba``
    (PIL's decode here, the port's on the card's machine) decodes them,
    in the file's order. PIL's file and the port's have the same digest
    where their directories, modes and pixels are the same: their PNGs are
    deflated differently."""
    h = hashlib.sha256()
    frames = []
    if data.startswith(b"icns"):
        h.update(data[:4])
        pos = 8
        while pos < len(data):
            kind, length = struct.unpack_from(">4sI", data, pos)
            body = data[pos + 8:pos + length]
            h.update(kind)
            if kind == b"TOC ":
                h.update(b"".join(body[i:i + 4]
                                  for i in range(0, len(body), 8)))
            else:
                frames.append(body)
            pos += length
    else:
        h.update(data[:6])
        for i in range(struct.unpack_from("<H", data, 4)[0]):
            entry = data[6 + 16 * i:22 + 16 * i]
            h.update(entry[:8])
            length, offset = struct.unpack_from("<II", entry, 8)
            frames.append(data[offset:offset + length])
    for png in frames:
        h.update(png[:8] + png[12:26])
        h.update(np.ascontiguousarray(png_rgba(png), np.uint8).tobytes())
    return h.hexdigest()


def file_digest(name: str, data: bytes, png_rgba) -> str:
    """:func:`icon_digest` of an ICO or ICNS file of PNG frames, the
    sha256 of any other (``ENCODED_ICONS`` too)."""
    if name.endswith(ICON_EXTENSIONS) and name not in ENCODED_ICONS:
        return icon_digest(data, png_rgba)
    return hashlib.sha256(data).hexdigest()


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
    """{image: {mode: {extension: :func:`file_digest` of PIL's file}}}
    (PDFs under :func:`pinned_gmtime`); where PIL raises, ``"<type>:
    <message>"`` (:data:`QOI_L_RAISES`). PIL's QOI encoder is Python, a
    minute or so for the 4K image."""
    import tempfile
    from PIL import Image
    ti = _images_module()
    out = {}
    with tempfile.TemporaryDirectory() as tmp, pinned_gmtime():
        for name, modes in writer_images().items():
            for mode, px in modes.items():
                for ext in WRITE_EXTENSIONS:
                    path = os.path.join(tmp, "x" + ext)
                    try:
                        Image.fromarray(px).save(path)
                    except ValueError as e:
                        digest = f"{type(e).__name__}: {e}"
                        assert digest == QOI_L_RAISES, digest
                    else:
                        with open(path, "rb") as f:
                            digest = file_digest(ext, f.read(),
                                                 ti.pil_rgba8)
                    out.setdefault(name, {}).setdefault(mode, {})[ext] = \
                        digest
    return out


# PIL's JPEG 2000 files under its save options (no cinema profile): a
# 19x13 file for each of the reader's steps (layers cut by dB on the 5/3
# transform; RPCL with precincts; tiles with odd image and tile offsets;
# 9/7 with ICT; RCT; signed samples), the j2k-lossy session's maps (a
# 2048x2048 grey 9/7 JP2 of three rate layers, a 1024x1024 RGB 9/7 + ICT
# codestream in 256x256 tiles at odd offsets, RPCL, 128x128 precincts, two
# layers: procedural_rgb's content, the seed the number) and a 512x512
# ICNS whose ic09 entry is a 9/7 JP2 of one rate layer
# (name: (side or None for 19x13, seed, mode, Image.save's options))
J2K_OPTION_FILES = {
    "small_layers_db.j2k": (None, 51, "L", {
        "quality_mode": "dB", "quality_layers": [30, 40]}),
    "small_rpcl_precincts.jp2": (None, 52, "RGBA", {
        "progression": "RPCL", "precinct_size": (32, 32),
        "codeblock_size": (16, 16)}),
    "small_tiles_offsets.j2k": (None, 53, "RGB", {
        "tile_size": (16, 16), "tile_offset": (3, 5), "offset": (7, 9)}),
    "small_97_ict.jp2": (None, 54, "RGB", {"irreversible": True, "mct": 1}),
    "small_rct.j2k": (None, 55, "RGB", {"mct": 1}),
    "small_signed.jp2": (None, 56, "LA", {"signed": True}),
    "roughness_2048_97_layers.jp2": (2048, 41, "L", {
        "irreversible": True, "quality_layers": [160, 80, 40]}),
    "normal_1024_97_ict_tiles.j2k": (1024, 43, "RGB", {
        "irreversible": True, "mct": 1, "tile_size": (256, 256),
        "tile_offset": (3, 5), "offset": (131, 133), "progression": "RPCL",
        "precinct_size": (128, 128), "quality_layers": [50, 25]}),
    "icon_512_jp2_97.icns": (512, 45, "RGB", {
        "irreversible": True, "quality_layers": [20]}),
}


def j2k_option_file(name: str) -> bytes:
    """The bytes of :data:`J2K_OPTION_FILES`'s ``name``, written by PIL
    (the ICNS by :func:`icns_bytes` around PIL's JP2 file)."""
    from PIL import Image
    side, seed, mode, save = J2K_OPTION_FILES[name]
    w, h = (19, 13) if side is None else (side, side)
    px = procedural_rgb(w, h, seed)
    if mode in ("LA", "RGBA"):
        px = np.concatenate([px, procedural_rgb(w, h, seed + 100)[..., :1]],
                            -1)
        if mode == "LA":
            px = px[..., [1, 3]]
    elif mode == "L":
        px = px[..., 1]
    out = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(px), mode).save(
        out, "JPEG2000", no_jp2=name.endswith(".j2k"), **save)
    if name.endswith(".icns"):
        return icns_bytes((b"ic09", out.getvalue()))
    return out.getvalue()


HIGH_BYTE = ("the high byte of each 16-bit sample (the port's named "
             "deviation: PIL clips mode I;16 at 255)")


def grey_rgba(grey: np.ndarray) -> np.ndarray:
    """[H, W, 4] uint8 of a grey [H, W] image, opaque."""
    out = np.full(grey.shape + (4,), 255, np.uint8)
    out[..., :3] = np.asarray(grey, np.uint8)[..., None]
    return out


def xv_index(rgb: np.ndarray) -> np.ndarray:
    """The 3-3-2 palette index of each RGB pixel (XV's thumbnails)."""
    r, g, b = (rgb[..., i].astype(np.uint8) for i in range(3))
    return (r >> 5) << 5 | (g >> 5) << 2 | b >> 6


def raster_files(small: np.ndarray) -> dict:
    """{name: (file, RGBA8 the port must decode or None for PIL's)}: 13x9
    files (the top-left corner of ``small``; few bytes, as every byte of
    them is damaged in ``tests/test_torch_damage.py``) of the raw-decoder
    formats: FITS at BITPIX 8, 16 and -32 (big-endian, as the standard
    stores them; the data unit not padded to 2,880 bytes) and GZIP_1 at
    ZBITPIX 8, McIDAS of three 1-byte bands with a 4-byte line prefix,
    PIL's SPIDER, PIXAR, IMT and XV thumbnail files and a DCX of two
    pages (PIL's RGB and L PCX files)."""
    from PIL import Image
    px = np.ascontiguousarray(small[:9, :13])
    grey = px[..., 1]
    wide = (grey.astype(np.int64) - 128) * 256 + px[..., 2]
    buf = io.BytesIO()
    Image.fromarray(grey.astype(np.float32) * 1.5 - 40, "F").save(
        buf, "SPIDER")
    return {
        "small_8.fits": (fits_bytes(grey[::-1], 8, pad=False), None),
        # PIL reads the big-endian samples little-endian: the high byte
        # of its sample is the low byte of the file's
        "grey16.fits": (fits_bytes(wide[::-1], 16, pad=False),
                        grey_rgba(px[..., 2])),
        "small_f32.fits": (fits_bytes(grey[::-1] * 1.5 - 40, -32,
                                      pad=False), None),
        "small_gzip.fits": (fits_gzip_bytes(grey[::-1], 8, pad=False),
                            None),
        "small.mcidas": (mcidas_bytes(px.reshape(9, 39), 1, prefix=4,
                                      bands=3), None),
        "small.spider": (buf.getvalue(), None),
        "small.pxr": (pixar_bytes(px), None),
        "small.imt": (imt_bytes(grey, (b"a procedural image",)), None),
        "small.xvthumb": (xvthumb_bytes(xv_index(px)), None),
        "small_two_pages.dcx": (dcx_bytes([pil_pcx(px), pil_pcx(grey)]),
                                None),
    }


# the raw-decoder maps chip_smoke.py makes and times: 2048x2048 FITS at
# BITPIX 8 (the fits-pixar session's roughness map), 16 and -32 and as
# GZIP_1 tiles (ZBITPIX 8, stored deflate blocks, so the same bytes on
# every machine), a 2-byte McIDAS and a SPIDER file, a 1024x1024 PIXAR
# (the fits-pixar session's normal map) and a DCX whose first page is a
# 1024x1024 RGB PCX; (side, seed of procedural_rgb)
RASTER_MAPS = {"roughness_2048.fits": (2048, 41),
               "grey16_2048.fits": (2048, 42),
               "float_2048.fits": (2048, 43),
               "roughness_2048_gzip.fits": (2048, 44),
               "grey16_2048.mcidas": (2048, 45),
               "float_2048.spider": (2048, 46),
               "normal_1024.pxr": (1024, 47),
               "normal_1024.dcx": (1024, 48)}


def raster_map(name: str, pcx=None) -> "tuple[bytes, np.ndarray | None]":
    """(file bytes, the RGBA8 of the port's named deviation or None) of
    one of ``RASTER_MAPS``, its content :func:`procedural_rgb`'s (integers
    only): the FITS and McIDAS files of its green channel (the 16-bit
    ones of green and blue as high and low bytes, the float ones of green
    times 1.25 less 30.5), rows written bottom-up where the format reads
    them so; the DCX's pages ``pcx``'s files (a writer: [H, W, 3] or
    [H, W] uint8 to a PCX file's bytes, by default :func:`pil_pcx`)."""
    n, seed = RASTER_MAPS[name]
    px = procedural_rgb(n, n, seed)
    grey = px[..., 1]
    wide = (grey.astype(np.int64) - 128) * 256 + px[..., 2]
    flt = grey.astype(np.float32) * np.float32(1.25) - np.float32(30.5)
    if name == "roughness_2048.fits":
        return fits_bytes(grey[::-1], 8), None
    if name == "grey16_2048.fits":
        return fits_bytes(wide[::-1], 16), grey_rgba(px[..., 2])
    if name == "float_2048.fits":
        return fits_bytes(flt[::-1], -32), None
    if name.endswith("_gzip.fits"):
        return fits_gzip_bytes(grey[::-1], 8, stored=True), None
    if name.endswith(".mcidas"):
        return (mcidas_bytes(wide & 0xFFFF, 2, prefix=8),
                grey_rgba((grey.astype(np.int64) - 128) & 0xFF))
    if name.endswith(".spider"):
        return spider_bytes(flt), None
    if name.endswith(".pxr"):
        return pixar_bytes(px), None
    pages = [(pcx or pil_pcx)(px), (pcx or pil_pcx)(grey[:64, :96])]
    return dcx_bytes(pages), None


def raster_map_digests() -> dict:
    """{map: {"file_sha256", "rgba_sha256", "shape", "of"}} of each of
    ``RASTER_MAPS``: the sha256 of its file and of PIL's
    ``convert("RGBA")`` of it (of the high-byte image for the 16-bit
    maps)."""
    ti = _images_module()
    out = {}
    for name in RASTER_MAPS:
        data, high = raster_map(name)
        rgba = ti.pil_rgba8(data) if high is None else high
        out[name] = {"file_sha256": hashlib.sha256(data).hexdigest(),
                     "rgba_sha256": hashlib.sha256(
                         rgba.tobytes()).hexdigest(),
                     "shape": list(rgba.shape),
                     "of": 'PIL 12.1 convert("RGBA")' if high is None
                     else HIGH_BYTE}
    return out


# ---- the X11 and Sun bitmaps: SUN, GBR, MSP, XBM, XPM -----------------------

def sun_rows(px: np.ndarray, depth: int, kind: int = 1) -> np.ndarray:
    """[h, row bytes] of ``px`` as a Sun raster stores it, unpadded: at
    depth 1 the bits of [h, w] (a set bit black), at 4 the nibbles, at 8
    the bytes; at 24 and 32 [h, w, 3] RGB as BGR, or RGB where ``kind``
    is 3, with a fourth byte 0xA5 at 32 (which readers ignore)."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape[:2]
    if depth == 1:
        return np.packbits(px, axis=1)
    if depth == 4:
        even = np.zeros((h, w + w % 2), np.uint8)
        even[:, :w] = px
        return even[:, 0::2] << 4 | even[:, 1::2]
    if depth == 8:
        return px
    rgb = px if kind == 3 else px[..., ::-1]
    if depth == 32:
        rgb = np.concatenate([rgb, np.full((h, w, 1), 0xA5, np.uint8)], 2)
    return rgb.reshape(h, -1)


def sun_rle_bytes(raw: bytes) -> bytes:
    """``raw`` as the run-length records of a Sun raster of type 2: each run
    of a byte in records of up to 256 (``80 n-1 v``; a single 0x80 as
    ``80 00``, runs of one or two other bytes as themselves)."""
    a = np.frombuffer(raw, np.uint8)
    if not a.size:
        return b""
    starts = np.r_[0, np.flatnonzero(np.diff(a)) + 1]
    lengths = np.diff(np.r_[starts, a.size])
    chunks = -(-lengths // 256)
    value = np.repeat(a[starts], chunks)
    count = np.full(value.size, 256)
    count[np.cumsum(chunks) - 1] = lengths - 256 * (chunks - 1)
    literal = (value != 0x80) & (count <= 2)
    single = (value == 0x80) & (count == 1)
    size = np.where(literal, count, np.where(single, 2, 3))
    at = np.cumsum(size) - size
    out = np.zeros(int(size.sum()), np.uint8)
    out[at] = np.where(literal, value, 0x80)
    two = size >= 2
    out[at[two] + 1] = np.where(literal, value, np.where(single, 0, count - 1)
                                )[two]
    run = size == 3
    out[at[run] + 2] = value[run]
    return out.tobytes()


def sun_bytes(px: np.ndarray, depth: int, kind: int = 1, colours: bytes = b"",
              map_type: int = 1, length=None) -> bytes:
    """A Sun raster file of ``px`` (:func:`sun_rows`): the 32-byte header
    (``length`` the data's length unless given), the colour map
    ``colours`` (planar: the reds, greens, blues), then raw rows padded
    to 16 bits, or for ``kind`` 2 :func:`sun_rle_bytes` of the unpadded
    rows."""
    rows = sun_rows(px, depth, kind)
    h, w = np.asarray(px).shape[:2]
    if kind == 2:
        data = sun_rle_bytes(rows.tobytes())
    else:
        padded = np.zeros((h, (w * depth + 15) // 16 * 2), np.uint8)
        padded[:, :rows.shape[1]] = rows
        data = padded.tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth,
                       len(data) if length is None else length, kind,
                       map_type if colours else 0, len(colours)) + (
                           colours + data)


def gbr_bytes(px: np.ndarray, version: int = 2, header_size=None,
              comment: bytes = b"procedural\0", spacing: int = 25) -> bytes:
    """A GIMP brush of ``px`` ([h, w] grey, depth 1, or [h, w, 4] RGBA,
    depth 4): the header (``header_size`` 20 or 28 bytes and the comment's
    unless given; version 2 adds ``GIMP`` and the spacing), the comment,
    the pixels."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape[:2]
    depth = 1 if px.ndim == 2 else 4
    tail = b"GIMP" + struct.pack(">I", spacing) if version == 2 else b""
    size = 20 + len(tail) + len(comment)
    return (struct.pack(">5I", size if header_size is None else header_size,
                        version, w, h, depth) + tail + comment + px.tobytes())


def msp_header(magic: bytes, w: int, h: int) -> bytes:
    """The 32-byte header PIL's MSP writer makes, under ``magic`` (``DanM``
    or ``LinS``): the size twice, the aspect words 1, the checksum that
    makes the 16 words XOR to 0 in word 12."""
    words = [0] * 16
    words[0], words[1] = struct.unpack("<2H", magic)
    words[2], words[3], words[8], words[9] = w, h, w, h
    words[4:8] = [1, 1, 1, 1]
    for v in words[:12]:
        words[12] ^= v
    return struct.pack("<16H", *words)


def msp_rle_row(row: bytes) -> bytes:
    """One row of a ``LinS`` file: each run of three or more equal bytes
    as ``00 n v`` (n up to 255), the bytes between as literal runs of up
    to 255 after their count."""
    a = np.frombuffer(row, np.uint8)
    starts = np.r_[0, np.flatnonzero(np.diff(a)) + 1] if a.size else []
    out, literal = bytearray(), bytearray()

    def flush():
        for i in range(0, len(literal), 255):
            out.append(len(literal[i:i + 255]))
            out.extend(literal[i:i + 255])
        literal.clear()

    for s, e in zip(list(starts), list(starts[1:]) + [a.size]):
        if e - s >= 3:
            flush()
            for i in range(s, e, 255):
                out.extend((0, min(255, e - i), a[s]))
        else:
            literal.extend(row[s:e])
    flush()
    return bytes(out)


def msp_bytes(bits: np.ndarray, rle: bool = False) -> bytes:
    """A Windows Paint file of ``bits`` ([h, w] 0 or 1, a set bit white):
    ``DanM`` and the packed rows (PIL's writer's file), or ``LinS``, its
    row map and each row by :func:`msp_rle_row`."""
    h, w = bits.shape
    rows = np.packbits(np.asarray(bits, np.uint8), axis=1)
    if not rle:
        return msp_header(b"DanM", w, h) + rows.tobytes()
    coded = [msp_rle_row(r.tobytes()) for r in rows]
    return (msp_header(b"LinS", w, h)
            + struct.pack(f"<{h}H", *(len(c) for c in coded))
            + b"".join(coded))


def xbm_bytes(bits: np.ndarray, hotspot=None) -> bytes:
    """An X11 bitmap of ``bits`` ([h, w] 0 or 1, a set bit white, the rows
    bit-reversed) as PIL's XBM writer writes it: ``0x%02x`` values, 15 a
    line."""
    h, w = bits.shape
    vals = np.packbits(np.asarray(bits, np.uint8), axis=1,
                       bitorder="little").reshape(-1)
    digits = np.frombuffer(b"0123456789abcdef", np.uint8)
    text = np.empty((vals.size, 5), np.uint8)
    text[:, :2] = np.frombuffer(b"0x", np.uint8)
    text[:, 2], text[:, 3] = digits[vals >> 4], digits[vals & 15]
    text[:, 4] = 44
    text = text.tobytes()
    head = b"#define im_width %d\n#define im_height %d\n" % (w, h)
    if hotspot:
        head += b"#define im_x_hot %d\n#define im_y_hot %d\n" % hotspot
    body = b"\n".join(text[i:i + 75] for i in range(0, len(text), 75))[:-1]
    return head + b"static char im_bits[] = {\n" + body + b"\n};\n"


# the characters of XPM keys here (no quote, no backslash)
XPM_CHARS = (b"0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
             b".#")


def xpm_bytes(index: np.ndarray, keys, colours) -> bytes:
    """An X11 pixmap: ``"w h n cpp"``, one ``"key c spec"`` line for each of
    ``keys`` and ``colours`` (``#`` and hex digits, or ``None``), then the
    rows of ``index`` ([h, w] into them) as quoted lines of keys."""
    h, w = index.shape
    cpp = len(keys[0])
    table = np.frombuffer(b"".join(keys), np.uint8).reshape(-1, cpp)
    rows = np.empty((h, w * cpp + 4), np.uint8)
    rows[:, 0], rows[:, -3:] = 34, np.frombuffer(b'",\n', np.uint8)
    rows[:, 1:-3] = table[index].reshape(h, -1)
    body = rows.tobytes()
    return (b"/* XPM */\nstatic char *procedural[] = {\n"
            b"/* columns rows colors chars-per-pixel */\n"
            + b'"%d %d %d %d ",\n' % (w, h, len(keys), cpp)
            + b"".join(b'"%s c %s",\n' % (k, c) for k, c in zip(keys, colours))
            + b"/* pixels */\n" + body[:-2] + b"\n};\n")


def xpm_of(rgb: np.ndarray, shift: int, cpp: int):
    """(index, keys, colours) of ``rgb`` quantised by ``shift`` bits a
    channel: the colours used, in order of their value, keys of ``cpp``
    characters of :data:`XPM_CHARS`."""
    q = (np.asarray(rgb, np.int64) >> shift) << shift
    code = q[..., 0] << 16 | q[..., 1] << 8 | q[..., 2]
    used, index = np.unique(code, return_inverse=True)
    chars = np.frombuffer(XPM_CHARS, np.uint8)
    digits = [(np.arange(used.size) // len(chars) ** i) % len(chars)
              for i in range(cpp)][::-1]
    keys = [bytes(chars[list(k)]) for k in zip(*digits)]
    return (index.reshape(code.shape), keys,
            [b"#%06X" % int(v) for v in used])


def bitmap_files(small: np.ndarray) -> dict:
    """{name: file}: 13x9 files (the top-left corner of ``small``; few
    bytes, as every byte of them is damaged in
    ``tests/test_torch_damage.py``) of the X11 and Sun bitmaps: Sun
    rasters at 8 bits run-length (runs across rows, single and run 0x80
    bytes), 8 bits under a 16-entry colour map (indices past it), 24 bits
    of type 3, 32 bits run-length and 1 bit; GIMP brushes of version 1 at
    depth 1 and version 2 at depth 4; PIL's MSP file and a ``LinS`` one; PIL's
    XBM with a hotspot; an XPM of 1-character keys, ``#RGB`` and 48-bit
    colours and an unused ``None``."""
    from PIL import Image
    px = np.ascontiguousarray(small[:9, :13])
    grey = np.repeat(px[:, ::3, 1], 3, 1)[:, :13]
    grey[2, 4:] = 0x80
    grey[5, 6] = 0x80
    bits = (px[..., 0] > px[..., 2]).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(bits.astype(bool)).save(buf, "MSP")
    xbm = io.BytesIO()
    Image.fromarray(bits.astype(bool)).save(xbm, "XBM", hotspot=(3, 4))
    index = (px[..., 1] // 64).astype(np.int64) + 2 * (px[..., 0] > 128)
    return {
        "small_rle.ras": sun_bytes(grey, 8, 2),
        "small_pal.ras": sun_bytes(px[..., 2] // 13, 8,
                                   colours=hashed_bytes(48, 61).tobytes()),
        "small_24.ras": sun_bytes(px, 24, 3),
        "small_32_rle.ras": sun_bytes(px // 32 * 32, 32, 2),
        "small_1.ras": sun_bytes(bits, 1),
        "small_v1.gbr": gbr_bytes(px[..., 1], 1, comment=b"v1\0"),
        "small_v2.gbr": gbr_bytes(np.concatenate([px, grey[..., None]], 2)),
        "small.msp": buf.getvalue(),
        "small_rle.msp": msp_bytes(bits, rle=True),
        "small.xbm": xbm.getvalue(),
        "small.xpm": xpm_bytes(
            index, [b".", b"#", b"a", b"b", b"c", b"d", b" "],
            [b"#F00", b"#123456789ABC", b"#00FF00", b"#0000FF", b"#808080",
             b"#FFFFFF", b"None"]),
    }


# the X11 and Sun bitmaps chip_smoke.py makes and times: 2048x2048 Sun
# rasters at 8 bits run-length (the sun-xpm session's roughness map) and
# 24 bits raw and a LinS MSP file, 1024x1024 a GIMP brush at depth 4, an
# XBM, an XPM of P mode and one of RGB mode with 2-character keys (the
# sun-xpm session's normal map); (side, seed of procedural_rgb)
BITMAP_MAPS = {"roughness_2048_rle.ras": (2048, 51),
               "roughness_2048_24.ras": (2048, 52),
               "roughness_2048.msp": (2048, 53),
               "normal_1024.gbr": (1024, 54),
               "normal_1024.xbm": (1024, 55),
               "normal_1024_p.xpm": (1024, 56),
               "normal_1024.xpm": (1024, 57)}


def bitmap_map(name: str) -> bytes:
    """The file of one of ``BITMAP_MAPS``, its content
    :func:`procedural_rgb`'s: the Sun rasters of its green channel (runs
    of 17 pixels) and of its RGB, the MSP and XBM files of green over 127
    and of red's bit 6, the brush of RGB and blue as alpha, the P XPM of 2
    bits a channel in 1-character keys, the RGB XPM of 4 bits a channel in
    2-character keys."""
    n, seed = BITMAP_MAPS[name]
    px = procedural_rgb(n, n, seed)
    if name.endswith("_rle.ras"):
        return sun_bytes(px[..., 1], 8, 2)
    if name.endswith(".ras"):
        return sun_bytes(px, 24)
    if name.endswith(".msp"):
        return msp_bytes((px[..., 1] > 127).astype(np.uint8), rle=True)
    if name.endswith(".gbr"):
        return gbr_bytes(np.concatenate([px, px[..., 2:]], 2))
    if name.endswith(".xbm"):
        return xbm_bytes(px[..., 0] >> 6 & 1)
    if name.endswith("_p.xpm"):
        return xpm_bytes(*xpm_of(px, 6, 1))
    return xpm_bytes(*xpm_of(px, 4, 2))


def pil_map_digests(names, make) -> dict:
    """{map: {"file_sha256", "rgba_sha256", "shape", "of"}} of each of
    ``names``: the sha256 of its file ``make(name)`` and of PIL's
    ``convert("RGBA")`` of it."""
    ti = _images_module()
    out = {}
    for name in names:
        data = make(name)
        rgba = ti.pil_rgba8(data)
        out[name] = {"file_sha256": hashlib.sha256(data).hexdigest(),
                     "rgba_sha256": hashlib.sha256(
                         rgba.tobytes()).hexdigest(),
                     "shape": list(rgba.shape),
                     "of": 'PIL 12.1 convert("RGBA")'}
    return out


def bitmap_map_digests() -> dict:
    """:func:`pil_map_digests` of ``BITMAP_MAPS``."""
    return pil_map_digests(BITMAP_MAPS, bitmap_map)


# ---- FLI/FLC, PhotoCD and IPTC ---------------------------------------------

def fli_chunk(kind: int, body: bytes, size=None) -> bytes:
    """A subchunk: its 32-bit size (the 6-byte header included, unless
    ``size`` is given), its type, its body."""
    return struct.pack("<IH", 6 + len(body) if size is None else size,
                       kind) + body


def fli_frame(chunks, size=None) -> bytes:
    """A frame chunk (type 0xF1FA) of the subchunks, 16-byte header."""
    body = b"".join(chunks)
    return struct.pack("<IHH", 16 + len(body) if size is None else size,
                       0xF1FA, len(chunks)) + bytes(8) + body


def fli_bytes(w: int, h: int, frames, magic: int = 0xAF12, flags: int = 3,
              n_frames=None, prefix: bytes = b"") -> bytes:
    """An FLI (``magic`` 0xAF11) or FLC (0xAF12) file: the 128-byte header
    (8-bit depth, speed 5, the reserved fields zero), ``prefix`` (an FLC
    prefix chunk, 0xF100), the frames."""
    head = bytearray(128)
    frames = b"".join(frames)
    struct.pack_into("<IHHHHHHI", head, 0, 128 + len(prefix) + len(frames),
                     magic, len(frames and [1]) if n_frames is None
                     else n_frames, w, h, 8, flags, 5)
    struct.pack_into("<HH", head, 38, 1, 1)
    return bytes(head) + prefix + frames


def fli_colour(palette: np.ndarray, skips=None) -> bytes:
    """A colour chunk's body: one packet per row of ``palette`` blocks
    (``skips``: [(skip, count)] splitting it, a count of 256 written as
    0), the triplets as given (6 bits for chunk 11)."""
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    skips = skips or [(0, len(pal))]
    out, at = bytearray(struct.pack("<H", len(skips))), 0
    for skip, count in skips:
        out += bytes([skip, count & 255]) + pal[at:at + count].tobytes()
        at += count
    return bytes(out)


def _runs(row: np.ndarray):
    """(start, length, value) of the runs of equal bytes of ``row``."""
    starts = np.r_[0, np.flatnonzero(np.diff(row)) + 1]
    lengths = np.diff(np.r_[starts, row.size])
    return zip(starts.tolist(), lengths.tolist(), row[starts].tolist())


def fli_brun(index: np.ndarray) -> bytes:
    """A BRUN (15) body: per line an (unused) packet count byte, then a
    run of 2 or more equal bytes as a count up to 127 and the byte, the
    bytes between as literals of up to 128 after 256 - their count."""
    out = bytearray()
    for row in np.asarray(index, np.uint8):
        out.append(0)
        literal = bytearray()

        def flush():
            for i in range(0, len(literal), 128):
                part = literal[i:i + 128]
                out.append(256 - len(part))
                out.extend(part)
            literal.clear()

        for start, length, value in _runs(row):
            if length == 1:
                literal.append(value)
                continue
            flush()
            while length:
                n = min(length, 127)
                out += bytes([n, value])
                length -= n
        flush()
    return bytes(out)


def fli_lc(index: np.ndarray, y0: int = 0, step: int = 200) -> bytes:
    """An LC (12) body writing ``index``'s rows from line ``y0``: per line
    packets of a skip of 0 and, per ``step`` bytes, a run (as 256 - n: a
    segment of one value) or a copy of up to 127 bytes, split further."""
    index = np.asarray(index, np.uint8)
    out = bytearray(struct.pack("<HH", y0, index.shape[0]))
    for row in index:
        packets = bytearray()
        count = 0
        for at in range(0, row.size, step):
            seg = row[at:at + step]
            for i in range(0, seg.size, 127):
                part = seg[i:i + 127]
                if (part == part[0]).all():
                    packets += bytes([0, 256 - part.size, part[0]])
                else:
                    packets += bytes([0, part.size]) + part.tobytes()
                count += 1
        out.append(count)
        out += packets
    return bytes(out)


def fli_ss2(index: np.ndarray, every: int = 1) -> bytes:
    """An SS2 (7) body writing every ``every``-th line of ``index`` (the
    lines between skipped by a 0xC000 word), each as packets of a skip of
    0 and runs (pairs of equal words) or copies of up to 127 words; an odd
    width's last byte by a 0x80nn word."""
    index = np.asarray(index, np.uint8)
    h, w = index.shape
    lines = list(range(0, h, every))
    out = bytearray(struct.pack("<H", len(lines)))
    for k, y in enumerate(lines):
        row = index[y]
        words = bytearray()
        if k and every > 1:
            words += struct.pack("<H", 65536 - (every - 1))
        if w % 2:
            words += struct.pack("<H", 0x8000 | int(row[-1]))
        pairs = row[:w - w % 2].reshape(-1, 2)
        packets = bytearray()
        count = 0
        for i in range(0, len(pairs), 127):
            part = pairs[i:i + 127]
            if (part == part[0]).all():
                packets += bytes([0, 256 - len(part)]) + part[0].tobytes()
            else:
                packets += bytes([0, len(part)]) + part.tobytes()
            count += 1
        out += words + struct.pack("<H", count) + packets
    return bytes(out)


PCD_OFFSET = 96 * 2048


def pcd_bytes(luma: np.ndarray, cb: np.ndarray, cr: np.ndarray,
              orientation: int = 0) -> bytes:
    """A PhotoCD file of its 768x512 base image: ``PCD_IPI`` at byte 2,048,
    the orientation in byte 3,586, then from byte 196,608 256 chunks of two
    luma lines ([512, 768] ``luma``) and their 384 Cb and 384 Cr samples
    ([256, 384] ``cb`` and ``cr``); 786,432 bytes."""
    head = bytearray(PCD_OFFSET)
    head[2048:2055] = b"PCD_IPI"
    head[2048 + 1538] = orientation
    body = np.concatenate([np.asarray(luma, np.uint8).reshape(256, 1536),
                           np.asarray(cb, np.uint8),
                           np.asarray(cr, np.uint8)], 1)
    return bytes(head) + body.tobytes()


def pcd_of(rgb: np.ndarray, seed: int):
    """(luma, cb, cr) of a PhotoCD image: ``rgb``'s green channel as the
    luma ([512, 768]) and hashed chroma about the neutral (156, 137)."""
    cb = 156 + (hashed_bytes(256 * 384, seed).reshape(256, 384) >> 3) - 16
    cr = 137 + (hashed_bytes(256 * 384, seed + 1).reshape(256, 384) >> 3) - 16
    return rgb[..., 1], cb.astype(np.uint8), cr.astype(np.uint8)


def iptc_field(record: int, dataset: int, data: bytes,
               length_bytes: int = 0) -> bytes:
    """An IPTC field as PIL reads one: 0x1C, the record and dataset
    numbers, then the length in two bytes or, for ``length_bytes`` 1-4,
    the byte 128 + that count, a byte PIL reads with it and ignores, and
    the length in as many bytes (big-endian)."""
    if length_bytes:
        return (bytes([0x1C, record, dataset, 0x80 + length_bytes, 0])
                + len(data).to_bytes(length_bytes, "big") + data)
    return bytes([0x1C, record, dataset]) + struct.pack(">H", len(data)) + data


def iptc_bytes(w: int, h: int, data: bytes, layers: int = 1,
               component: int = 0, compression: int = 1, band=None,
               chunk: int = 32000, extra=b"") -> bytes:
    """An IPTC/NAA file: an envelope field, (3, 20) and (3, 30) the size,
    (3, 60) layers and component, (3, 65) ``band`` (1-based) where given,
    (3, 120) the compression, ``extra`` fields, then the image data in
    (8, 10) fields of ``chunk`` bytes (a field of 32,768 or more in the
    4-byte length form)."""
    out = [iptc_field(1, 90, b"\x1b%G"), iptc_field(3, 20, struct.pack(
        ">I", w)), iptc_field(3, 30, struct.pack(">I", h)),
           iptc_field(3, 60, bytes([layers, component]))]
    if band is not None:
        out.append(iptc_field(3, 65, bytes([band])))
    out += [iptc_field(3, 120, bytes([compression])), extra]
    for at in range(0, len(data), chunk):
        part = data[at:at + chunk]
        out.append(iptc_field(8, 10, part, 4 if len(part) >= 32768 else 0))
    return b"".join(out)


def fli_pcd_iptc_files(small: np.ndarray) -> dict:
    """{name: file}: 13x9 files (the top-left corner of ``small``; few
    bytes, as every byte of them is damaged in
    ``tests/test_torch_damage.py``) of FLI/FLC and IPTC: an FLI of a
    6-bit colour chunk in two packets, a BRUN frame and a postage stamp;
    an FLI without a colour chunk (the grey ramp) of LC lines from line
    2; an FLC of a 256-entry colour chunk (count 0), BLACK and SS2 lines
    with skips and the odd width's last byte, and a second frame; a raw
    ``L`` IPTC record in two image fields (the second in the long length
    form, of 2 bytes), a raw band 3 of a ``CMYK`` record, and PIL's JPEG in an
    ``L`` record (compression 5)."""
    px = np.ascontiguousarray(small[:9, :13])
    index = (px[..., 0] // 8 + px[..., 1] // 64 * 32).astype(np.uint8)
    index[3, 2:9] = 77
    pal = hashed_bytes(768, 63).reshape(256, 3)
    grey = np.ascontiguousarray(px[..., 1])
    return {
        "small.fli": fli_bytes(13, 9, [fli_frame([
            fli_chunk(11, fli_colour(pal[:60] >> 2, [(2, 40), (7, 20)])),
            fli_chunk(15, fli_brun(index)), fli_chunk(18, bytes(6))])],
            magic=0xAF11, flags=0),
        "small_lc.fli": fli_bytes(13, 9, [fli_frame([
            fli_chunk(12, fli_lc(index[2:], 2, 5))])], magic=0xAF11),
        "small.flc": fli_bytes(13, 9, [fli_frame([
            fli_chunk(4, fli_colour(pal, [(0, 256)])), fli_chunk(13, b""),
            fli_chunk(7, fli_ss2(index, 2))]),
            fli_frame([fli_chunk(16, bytes(13 * 9))])]),
        "small.iim": iptc_bytes(13, 9, b"") + iptc_field(
            8, 10, grey[:5].tobytes()) + iptc_field(8, 10, grey[5:].tobytes(),
                                                    2),
        "small_band.iim": iptc_bytes(13, 9, grey.tobytes(), 4, 1, band=3),
        "small_jpeg.iim": iptc_bytes(13, 9, pil_jpeg(px), compression=5),
    }


# the FLI/FLC, PhotoCD and IPTC files chip_smoke.py makes and times: a
# 2048x2048 FLC whose first frame is BRUN under a 256-entry colour chunk
# (the fli-pcd session's roughness map), a 2048x2048 FLI of LC and SS2
# chunks under a 6-bit one, 768x512 PhotoCDs at orientation 0 (the
# fli-pcd session's normal map) and 1, a 2048x2048 raw IPTC band of an
# RGB record and a 1024x1024 IPTC record of a baseline JPEG; (side, seed
# of procedural_rgb)
FLI_PCD_IPTC_MAPS = {"roughness_2048_brun.flc": (2048, 71),
                     "roughness_2048_lc_ss2.fli": (2048, 72),
                     "normal_768x512.pcd": (768, 73),
                     "normal_768x512_turned.pcd": (768, 74),
                     "roughness_2048_band.iim": (2048, 75),
                     "normal_1024_jpeg.iim": (1024, 76)}


def fli_pcd_iptc_map(name: str, jpg=None) -> bytes:
    """The file of one of ``FLI_PCD_IPTC_MAPS``, its content
    :func:`procedural_rgb`'s: the FLC of its green channel (the first 64
    columns its blue: literals among the runs) under a palette of another
    seed's pixels, the FLI of LC lines of its red channel and SS2 lines of
    its green every third line, the PhotoCDs of :func:`pcd_of` (the second
    turned), the IPTC band of its red channel in 1 MiB fields, the IPTC
    JPEG of :func:`normal_map` written by ``jpg`` (by default
    :func:`pil_jpeg`; the port's ``jpeg.encode`` is the same file)."""
    n, seed = FLI_PCD_IPTC_MAPS[name]
    if name.endswith("_jpeg.iim"):
        return iptc_bytes(n, n, (jpg or pil_jpeg)(normal_map(n)),
                          compression=5)
    if name.endswith(".pcd"):
        return pcd_bytes(*pcd_of(procedural_rgb(768, 512, seed), seed),
                         orientation=int(name.endswith("_turned.pcd")))
    px = procedural_rgb(n, n, seed)
    pal = procedural_rgb(256, 1, seed + 1)[0]
    if name.endswith(".flc"):
        index = px[..., 1].copy()
        index[:, :64] = px[:, :64, 2]
        return fli_bytes(n, n, [fli_frame([
            fli_chunk(4, fli_colour(pal, [(0, 256)])),
            fli_chunk(15, fli_brun(index))])])
    if name.endswith(".fli"):
        return fli_bytes(n, n, [fli_frame([
            fli_chunk(11, fli_colour(pal >> 2, [(0, 256)])),
            fli_chunk(12, fli_lc(px[..., 0])),
            fli_chunk(7, fli_ss2(px[..., 1], 3))])], magic=0xAF11)
    return iptc_bytes(n, n, px[..., 0].tobytes(), 3, 1, band=2,
                      chunk=1 << 20)


def fli_pcd_iptc_map_digests() -> dict:
    """:func:`pil_map_digests` of ``FLI_PCD_IPTC_MAPS``."""
    return pil_map_digests(FLI_PCD_IPTC_MAPS, fli_pcd_iptc_map)


# ---- the TIFFs of scientific and GIS tools ----------------------------------

TIFF_FLOAT_BIG_MAPS = {"roughness_2048_pred3.tif": (2048, 81),
                       "normal_1024_big.tif": (1024, 82),
                       "float_2048_big.tif": (2048, 83),
                       "grey12_2048.tif": (2048, 84),
                       "grey12_2048_lzw.tif": (2048, 85),
                       "rgb16_1024_planar.tif": (1024, 86),
                       "float_2048_pred3_zstd.tif": (2048, 87)}
TOP_12_BITS = ("the top 8 bits of each 12-bit sample (the port's named "
               "deviation: PIL clips mode I;16 at 255)")


def tiff_float_big_map(name: str) -> "tuple[bytes, np.ndarray | None]":
    """(file bytes, the RGBA8 of the port's named deviation or None) of
    one of ``TIFF_FLOAT_BIG_MAPS``, its content :func:`procedural_rgb`'s
    (integers, and floats exact in float32): the float maps its green
    channel times 1.25 less 30.5 (Adobe Deflate with the floating-point
    predictor in 64-row strips, an uncompressed BigTIFF, ZSTD stored
    blocks with the predictor in 256-row strips), the BigTIFF normal map
    its RGB under Deflate in 128-row strips (LONG8 offsets), the 12-bit
    grey maps its green channel as 12 bits (``g * 16 + g // 16``;
    uncompressed, LZW in 64-row strips), the planar map its channels times 257 as separate
    16-bit planes, uncompressed, in 256-row strips. Made with numpy,
    ``zlib`` and ``tests/torch_images.tiff_bytes`` only, so the card's
    machine makes the same bytes."""
    ti = _images_module()
    n, seed = TIFF_FLOAT_BIG_MAPS[name]
    px = procedural_rgb(n, n, seed)
    flt = (px[..., 1:2].astype(np.float32) * np.float32(1.25)
           - np.float32(30.5))
    grey12 = px[..., 1:2].astype(np.int64) * 16 + (px[..., 1:2] >> 4)
    if name == "roughness_2048_pred3.tif":
        return ti.tiff_bytes(flt, 32, sample_format=3, compression=32946,
                             predictor=3, rows_per_strip=64), None
    if name == "float_2048_big.tif":
        return ti.tiff_bytes(flt, 32, sample_format=3, big=True,
                             offset_type=16), None
    if name == "float_2048_pred3_zstd.tif":
        return ti.tiff_bytes(flt, 32, sample_format=3, compression=50000,
                             predictor=3, rows_per_strip=256), None
    if name == "normal_1024_big.tif":
        return ti.tiff_bytes(px, 8, compression=8, rows_per_strip=128,
                             big=True, offset_type=16), None
    if name == "rgb16_1024_planar.tif":
        return ti.tiff_bytes(px.astype(np.int64) * 257, 16, planar=2,
                             rows_per_strip=256), None
    data = ti.tiff_bytes(grey12, 12, compression=5 if name.endswith(
        "_lzw.tif") else 1, rows_per_strip=64)
    return data, grey_rgba(grey12[..., 0] >> 4)


def tiff_float_big_map_digests() -> dict:
    """{map: {"file_sha256", "rgba_sha256", "shape", "of"}} of each of
    ``TIFF_FLOAT_BIG_MAPS``: the sha256 of its file and of PIL's
    ``convert("RGBA")`` of it (of the top-8-bit image for the 12-bit
    maps)."""
    ti = _images_module()
    out = {}
    for name in TIFF_FLOAT_BIG_MAPS:
        data, high = tiff_float_big_map(name)
        rgba = ti.pil_rgba8(data) if high is None else high
        out[name] = {"file_sha256": hashlib.sha256(data).hexdigest(),
                     "rgba_sha256": hashlib.sha256(
                         rgba.tobytes()).hexdigest(),
                     "shape": list(rgba.shape),
                     "of": 'PIL 12.1 convert("RGBA")' if high is None
                     else TOP_12_BITS}
    return out


def tiff_float_big_files(small: np.ndarray) -> dict:
    """{name: (file, the RGBA8 of the port's named deviation or None)}:
    13x9 files (the top-left corner of ``small``) of the TIFFs
    scientific and GIS tools write: PIL's mode F file under Adobe Deflate
    with the floating-point predictor, a big-endian one under LZW in
    16x16 tiles, PIL's uncompressed RGB BigTIFF, an RGB BigTIFF under
    Deflate in 16x16 tiles with LONG8 offsets, uncompressed 12-bit grey
    (its digest the top-8-bit image) and uncompressed separate 16-bit RGB
    planes in two strips each."""
    from PIL import Image
    ti = _images_module()
    px = np.ascontiguousarray(small[:9, :13])
    flt = px[..., 1:2].astype(np.float32) * np.float32(1.25) - np.float32(
        30.5)
    flt[2, 3] = np.nan
    grey12 = px[..., :1].astype(np.int64) << 4 | px[..., 1:2] >> 4

    def pil_file(img, **save):
        out = io.BytesIO()
        img.save(out, "TIFF", **save)
        return out.getvalue()

    return {
        "small_pred3.tif": (pil_file(Image.fromarray(flt[..., 0]),
                                     compression="tiff_adobe_deflate",
                                     tiffinfo={317: 3}), None),
        "small_pred3_be_tiles.tif": (ti.tiff_bytes(
            flt, 32, sample_format=3, compression=5, predictor=3,
            order=">", tile=(16, 16)), None),
        "small_big.tif": (pil_file(Image.fromarray(px), big_tiff=True),
                          None),
        "small_big_deflate_tiles.tif": (ti.tiff_bytes(
            px, 8, compression=8, tile=(16, 16), big=True, offset_type=16),
            None),
        "grey12.tif": (ti.tiff_bytes(grey12, 12),
                       grey_rgba(grey12[..., 0] >> 4)),
        "small_planar16.tif": (ti.tiff_bytes(
            px.astype(np.int64) * 257 + 3, 16, planar=2, rows_per_strip=5),
            None),
    }


# ---- CIELab TIFF and PSD ------------------------------------------------------

CIELAB_MAPS = {"roughness_2048_lab_lzw.tif": (2048, 91),
               "normal_1024_lab_rle.psd": (1024, 92),
               "lab_2048_big_tiles.tif": (2048, 93),
               "lab_2048_jpeg.tif": (2048, 94)}
# committed under tests/torch_data (PIL's libtiff writes its JPEG stream
# in libjpeg's JCS_UNKNOWN colour space, which the port's encoder does not)
CIELAB_COMMITTED = ("lab_2048_jpeg.tif",)


def psd_rle_bytes(channels: np.ndarray, mode: int) -> bytes:
    """A PSD of uint8 ``channels`` [n, h, w] (the merged image) in colour
    mode ``mode``, its rows RLE (:func:`packbits_rows`, each row coded
    apart) after the table of their byte counts; no colour mode data,
    resources or layers."""
    n, h, w = channels.shape
    body, row_bytes = packbits_rows(np.ascontiguousarray(channels).reshape(
        n * h, w))
    return (b"8BPS" + struct.pack(">H6xHIIHH", 1, n, h, w, 8, mode)
            + struct.pack(">IIIH", 0, 0, 0, 1)
            + row_bytes.astype(">u2").tobytes() + body)


def cielab_jpeg_map() -> bytes:
    """PIL's JPEG-compressed CIELab TIFF of :func:`roughness_map`'s bytes
    as L*, a*, b* (its defaults: quality 75, JPEGTables, 1x1 sampling):
    ``lab_2048_jpeg.tif``. Needs PIL."""
    from PIL import Image
    out = io.BytesIO()
    Image.frombytes("LAB", (2048, 2048), roughness_map().tobytes()).save(
        out, "TIFF", compression="jpeg")
    return out.getvalue()


def cielab_map(name: str) -> bytes:
    """The file of one of ``CIELAB_MAPS``, its bytes stored as L*, a*, b*
    samples: :func:`roughness_map`'s in a TIFF under LZW with predictor 2
    in 64-row strips; :func:`procedural_rgb`'s uncompressed in a BigTIFF
    of 256x256 tiles with LONG8 offsets; :func:`normal_map`'s as the
    channels of an RLE PSD; the committed JPEG TIFF read from
    ``tests/torch_data``. Made with numpy and
    ``tests/torch_images.tiff_bytes`` only, so the card's machine makes
    the same bytes."""
    if name in CIELAB_COMMITTED:
        with open(os.path.join(OUT, name), "rb") as f:
            return f.read()
    ti = _images_module()
    n, seed = CIELAB_MAPS[name]
    if name.endswith(".psd"):
        return psd_rle_bytes(np.moveaxis(normal_map(n), -1, 0), 9)
    if name == "lab_2048_big_tiles.tif":
        return ti.tiff_bytes(procedural_rgb(n, n, seed), photometric=8,
                             tile=(256, 256), big=True, offset_type=16)
    return ti.tiff_bytes(roughness_map(n), photometric=8, compression=5,
                         predictor=2, rows_per_strip=64)


def cielab_map_digests() -> dict:
    """{"table": the sha256 of LittleCMS's own Lab to sRGB table at the 33
    grid nodes (``torch_images.lcms_table``, PIL's bundled lcms 2.17),
    "maps": :func:`pil_map_digests` of ``CIELAB_MAPS``}."""
    ti = _images_module()
    table = ti.lcms_table()
    return {"table": {"sha256": hashlib.sha256(
                table.astype("<u2").tobytes()).hexdigest(),
                      "shape": list(table.shape),
                      "of": "LittleCMS 2.17 (PIL 12.1's), no optimisation, "
                            "TYPE_Lab_16 to TYPE_RGB_16 at lcms's nodes"},
            "maps": pil_map_digests(CIELAB_MAPS, cielab_map)}


def cielab_files(small: np.ndarray) -> dict:
    """{name: file}: 13x9 CIELab files of the top-left corner of ``small``
    (its bytes as L*, a*, b*): PIL's TIFF under LZW, and an RLE PSD."""
    from PIL import Image
    px = np.ascontiguousarray(small[:9, :13])
    out = io.BytesIO()
    Image.frombytes("LAB", (13, 9), px.tobytes()).save(
        out, "TIFF", compression="tiff_lzw")
    return {"small_lab_lzw.tif": out.getvalue(),
            "small_lab_rle.psd": psd_rle_bytes(np.moveaxis(px, -1, 0), 9)}


def mixed_rgb(n: int = 256, noisy: int = 64) -> np.ndarray:
    """[n, n, 3] uint8: :func:`normal_map`'s bumps above ``noisy`` rows of
    hashed bytes (smooth rows and noise, for blocks of both kinds)."""
    px = normal_map(n, 4).copy()
    px[n - noisy:] = hashed_bytes(noisy * n * 3, 62).reshape(noisy, n, 3)
    return px


def tiff_compression_files(small: np.ndarray, alpha: np.ndarray) -> dict:
    """{name: PIL's TIFF file}: the ``tiff-lzma-zstd`` session's maps
    (``roughness_map``'s first channel as grey ZSTD with predictor 2,
    ``normal_map`` as RGB LZMA), a 256x256 ZSTD strip of two compressed
    blocks (:func:`mixed_rgb`, one 192 KiB strip), and 13x9 files (the
    top-left corner of ``small`` with ``alpha``: few bytes, as every byte
    of them is damaged in ``tests/test_torch_damage.py``) of RGBA
    (predictor 2) and I (32-bit, predictor 2) as LZMA, of LA (predictor 2)
    and F (predictor 2) as ZSTD, and of LA as JPEG."""
    from PIL import Image

    def tif(px, mode=None, **save):
        out = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(px), mode).save(out, "TIFF",
                                                             **save)
        return out.getvalue()

    rgba = np.concatenate([small, alpha], -1)[:9, :13]
    la = rgba[..., [1, 3]]
    pred = {"tiffinfo": {317: 2}}
    ints = np.random.default_rng(63).integers(-300, 900, (9, 13))
    return {
        "roughness_2048_zstd.tif": tif(roughness_map()[..., 0],
                                       compression="zstd", **pred),
        "normal_1024_lzma.tif": tif(normal_map(), compression="lzma"),
        "zstd_blocks_256.tif": tif(mixed_rgb(), compression="zstd",
                                   strip_size=1 << 18),
        "small_lzma_rgba.tif": tif(rgba, "RGBA", compression="lzma", **pred),
        "small_lzma_i.tif": tif(ints.astype(np.int32), compression="lzma",
                                **pred),
        "small_zstd_la.tif": tif(la, "LA", compression="zstd", **pred),
        "small_zstd_f.tif": tif(rgba[..., 0].astype(np.float32) * 1.5 - 40,
                                compression="zstd", **pred),
        "small_jpeg_la.tif": tif(la, "LA", compression="jpeg"),
    }


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
    high, how = grey_rgba(grey[..., 0] >> 8), HIGH_BYTE
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
    # PIL's QOI, DDS, ICO and JP2 files of the image with alpha, its ICNS
    # of a grey corner, its JPEG 2000 codestream of the green channel
    with_alpha = Image.fromarray(np.concatenate([small, alpha], -1), "RGBA")
    files = {"small.qoi": pil_file(with_alpha, "QOI"),
             "small_dxt5.dds": pil_file(with_alpha, "DDS",
                                        pixel_format="DXT5"),
             "small_rgba.dds": pil_file(with_alpha, "DDS"),
             "small.ico": pil_file(with_alpha, "ICO"),
             "small_6x5_grey.icns": pil_file(Image.fromarray(
                 np.ascontiguousarray(small[:5, :6, 1])), "ICNS"),
             "small_rgba.jp2": pil_file(with_alpha, "JPEG2000"),
             "small_grey.j2k": pil_file(Image.fromarray(
                 np.ascontiguousarray(small[..., 1])), "JPEG2000",
                 no_jp2=True)}
    # hashed BC6H SF16 blocks (bounded, every mode and reserved code) and
    # BC7 blocks (every mode and the reserved one) under the sRGB name
    blocks = -(-w // 4) * -(-h // 4)
    files["small_bc6h_sf16.dds"] = bcn_dds_bytes(bc6h_blocks(
        blocks, 36, signed=True, codes=BC6H_CODES + BC6H_RESERVED), w, h, 96)
    files["small_bc7_srgb.dds"] = bcn_dds_bytes(
        bc7_blocks(blocks, 38, range(9)), w, h, 99)
    # BLP: a BLP1 palette image with the alpha flag (its alpha the
    # palette's), a BLP1 JPEG of the YCCK fixture (its colour space forced
    # to CMYK: not the JPEG's own decode), BLP2 DXT1 without the flag
    files["small_palette.blp"] = blp1_bytes(
        w, h, hashed_bytes(w * h, 40).tobytes(), alpha=1,
        palette=hashed_bytes(1024, 41).tobytes())
    files["small_ycck.blp"] = blp1_jpeg_bytes(
        w, h, out["small_ycck_prog.jpg"][0])
    files["small_dxt1.blp"] = blp2_bytes(
        w, h, hashed_bytes(8 * blocks, 42).tobytes(), alpha=0)
    for name, data in files.items():
        out[name] = (data, ti.pil_rgba8(data), 'PIL 12.1 convert("RGBA")')
    # PIL's LZMA, ZSTD and two-channel JPEG TIFFs
    for name, data in tiff_compression_files(small, alpha).items():
        out[name] = (data, ti.pil_rgba8(data), 'PIL 12.1 convert("RGBA")')
    # the raw-decoder rasters: FITS, McIDAS, SPIDER, PIXAR, IMT, XV, DCX
    for name, (data, high) in raster_files(small).items():
        out[name] = (data, ti.pil_rgba8(data) if high is None else high,
                     'PIL 12.1 convert("RGBA")' if high is None else
                     HIGH_BYTE)
    # the X11 and Sun bitmaps: SUN, GBR, MSP, XBM, XPM
    for name, data in bitmap_files(small).items():
        out[name] = (data, ti.pil_rgba8(data), 'PIL 12.1 convert("RGBA")')
    # FLI/FLC and IPTC
    for name, data in fli_pcd_iptc_files(small).items():
        out[name] = (data, ti.pil_rgba8(data), 'PIL 12.1 convert("RGBA")')
    # BigTIFF, the floating-point predictor, 12-bit grey, 16-bit planes
    for name, (data, high) in tiff_float_big_files(small).items():
        out[name] = (data, ti.pil_rgba8(data) if high is None else high,
                     'PIL 12.1 convert("RGBA")' if high is None else
                     TOP_12_BITS)
    # CIELab: PIL's LZW TIFF and an RLE PSD
    for name, data in cielab_files(small).items():
        out[name] = (data, ti.pil_rgba8(data), 'PIL 12.1 convert("RGBA")')
    # PIL's JPEG 2000 files under its save options
    for name in J2K_OPTION_FILES:
        data = j2k_option_file(name)
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
    with open(os.path.join(OUT, "raster_map_digests.json"), "w") as f:
        json.dump(raster_map_digests(), f, indent=1, sort_keys=True)
        f.write("\n")
    with open(os.path.join(OUT, "bitmap_map_digests.json"), "w") as f:
        json.dump(bitmap_map_digests(), f, indent=1, sort_keys=True)
        f.write("\n")
    with open(os.path.join(OUT, "fli_pcd_iptc_map_digests.json"), "w") as f:
        json.dump(fli_pcd_iptc_map_digests(), f, indent=1, sort_keys=True)
        f.write("\n")
    with open(os.path.join(OUT, "tiff_float_big_map_digests.json"),
              "w") as f:
        json.dump(tiff_float_big_map_digests(), f, indent=1, sort_keys=True)
        f.write("\n")
    for name in CIELAB_COMMITTED:
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(cielab_jpeg_map())
    with open(os.path.join(OUT, "cielab_map_digests.json"), "w") as f:
        json.dump(cielab_map_digests(), f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
