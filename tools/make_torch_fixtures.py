#!/usr/bin/env python3
"""Write the image fixtures of the PyTorch port into ``tests/torch_data/``.

The machine with the card has no PIL, so ``chip_smoke.py`` holds the
port's decodes and writes there by digest. This script makes each fixture
with PIL (or by hand, for the PNG, TIFF, GIF and PSD flavours PIL does not
write) and records, in ``tests/torch_data/digests.json``, the sha256 of
PIL's ``convert("RGBA")`` bytes of each. For the 16-bit grey PNG and TIFF
it records the high-byte image instead: the port's named deviation from
PIL, which clips that mode at 255. ``tests/test_torch_formats.py`` checks
the digests against PIL's decode on every run.

It also records, in ``tests/torch_data/write_digests.json``, the sha256
of the file PIL's ``Image.save`` writes for two images (the 37x29 fixture
image and a 3840x2160 one made procedurally, in integers only, by
:func:`writer_images`) as L and RGB under each extension the port writes
byte for byte; no image is committed for these. ``chip_smoke.py`` imports
:func:`writer_images` from this file (PIL is imported only where it is
used).

And it records, in ``tests/torch_data/map_digests.json``, the sha256 of
each of ``READER_MAPS`` (the textured session's RLE SGI roughness map and
PCX normal map, made at run time by :func:`reader_map`: nothing is
committed) and of PIL's decode of it; ``chip_smoke.py`` holds the maps it
builds and the port's decodes of them to these.

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
- ``roughness_2048_lossy.webp`` (the roughness map's content as a lossy
  WebP, quality 80), ``normal_1024_lossless.webp`` (the normal map as a
  lossless WebP whose alpha is the bump height), and 37x29
  ``small_lossy.webp`` (VP8), ``small_lossy_alpha.webp`` (VP8X with an
  ALPH chunk), ``small_palette.webp`` (VP8L colour indexing, five
  colours) and ``small_anim.webp`` (two frames, the first cropped to a
  window at an offset).

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


# the textured session's maps read by the SGI and PCX readers, made at run
# time (nothing is committed): a 2048x2048 RGB roughness map as an RLE
# SGI file (sgi_rle_bytes) and a 1024x1024 RGB normal map as the PCX file
# Image.save writes (which the port's writer writes byte for byte); their
# content is procedural_rgb's, in integers only
READER_MAPS = {"roughness_2048_rle.sgi": (2048, 11),
               "normal_1024.pcx": (1024, 12)}


def reader_map(name: str) -> "tuple[np.ndarray, bytes | None]":
    """(pixels, file bytes) of one of ``READER_MAPS``: the RLE SGI file's
    bytes from :func:`sgi_rle_bytes`; None for the PCX, which the writer
    under test (PIL's or the port's ``write_image``) makes."""
    n, seed = READER_MAPS[name]
    px = procedural_rgb(n, n, seed)
    if name.endswith(".sgi"):
        return px, sgi_rle_bytes(px, name=b"roughness")
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
