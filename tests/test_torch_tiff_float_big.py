"""The TIFFs scientific and GIS tools write, as the port reads them in
``utils/image.py`` against the JAX package (PIL 12.1 and its libtiff
4.7.1): the port's ``load_rgba`` bit for bit as an int32 view of the
float32 and its ``load_rgba8`` as uint8 (tolerance 0), None where it is
None, apart from the mapped trace's rtol 1e-4 / atol 1e-6, as
``tests/test_torch_spectral.py`` states it.

- The repairs: predictor 3 on integer samples, predictor 2 at other than
  8, 16, 32 or 64 bits, predictor values other than 1-3 (libtiff's
  ``PredictorSetup`` fails the first strip), and the 12-bit and float
  keys PIL has no mode for: None in both.
- BigTIFF: PIL's classic files of 11 modes under every compression PIL
  writes (none, LZW, Deflate, PackBits, LZMA, ZSTD, JPEG, CCITT) made
  BigTIFF with LONG8 and LONG offsets, PIL's own ``big_tiff`` files,
  hand-made strips and tiles with values inline in 8 bytes, the header's
  checks (libtiff's offset size and zero word, PIL's reading of a
  big-endian BigTIFF as a classic file), a classic file damaged to magic
  43, offsets past 2**63.
- The floating-point predictor at 32 bits: PIL's files under LZW, Adobe
  Deflate, LZMA and ZSTD, hand-made ones in both byte orders, in strips
  and tiles, classic and BigTIFF.
- 12-bit grey (``I;12``): uncompressed and under LZW, Deflate, PackBits,
  LZMA and ZSTD, strips and tiles, at every orientation, the named
  deviation (the top 8 bits, where PIL clips at 255).
- Uncompressed separate 16-bit planes of RGB, RGBA and CMYK in one strip
  or several a plane, or in tiles, in both byte orders: PIL's quirk
  copied (each plane's bytes read as 8-bit samples).
- The flavours still refused, by name; the committed fixtures; the
  card's maps against ``tests/torch_data/tiff_float_big_map_digests.json``;
  a ``"hier"`` trace with a predictor-3 roughness map and a BigTIFF
  normal map against the JAX package's dense one; a render from such
  maps in a process that refuses to import jax and PIL.

``tools/tiff_float_big_sweep.py`` is the wide sweep (random files of the
four families, every cut, single-bit flips).
"""

import hashlib
import io
import json
import os
import struct
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pathtracing_spectrum_tpu import engine as jengine  # noqa: E402
from pathtracing_spectrum_tpu import camera_rays as jax_camera_rays  # noqa: E402,E501
from pathtracing_spectrum_tpu.utils import image as jimage  # noqa: E402
from pathtracing_spectrum_tpu_torch import engine  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import rng  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import image  # noqa: E402

from PIL import Image  # noqa: E402

import torch_images as ti  # noqa: E402
from test_torch_readers import as_jax, held  # noqa: E402
from test_torch_scene import to_port_scene  # noqa: E402
from test_torch_spectral import assert_same  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402
from test_torch_qoi_dds import REPO, fx  # noqa: E402

DATA = os.path.join(REPO, "tests", "torch_data")
R = np.random.default_rng(30)
RGB = R.integers(0, 256, (9, 13, 3), np.uint8)
RGB[:, :6] = RGB[:, :1]                              # runs for the codecs
FLOATS = (R.random((9, 13, 1)) * 400 - 60).astype(np.float32)
FLOATS[1, 2], FLOATS[3, 4], FLOATS[5, 6] = np.nan, np.inf, -3e38
GREY12 = R.integers(0, 4096, (9, 13, 1))
WIDE = R.integers(0, 65536, (9, 13, 4))
PREDICTED = {"LZW": 5, "Deflate": 8, "Adobe Deflate": 32946, "LZMA": 34925,
             "ZSTD": 50000}


def pil_tiff(img, **save) -> bytes:
    out = io.BytesIO()
    img.save(out, "TIFF", **save)
    return out.getvalue()


def deviation(tmp_path, data: bytes, shift: int) -> np.ndarray:
    """The port's RGBA8 of a file PIL opens as ``I;16``: PIL's samples
    shifted down by ``shift`` (the named deviation), where the JAX
    package's are clipped at 255."""
    path = tmp_path / "x.tif"
    path.write_bytes(data)
    with Image.open(str(path)) as im:
        assert im.mode == "I;16"
        samples = np.asarray(im).astype(np.int64)
    got = image.load_rgba8(str(path))
    np.testing.assert_array_equal(got[..., 0], samples >> shift)
    assert (got[..., 1] == got[..., 0]).all() and (got[..., 3] == 255).all()
    pil = np.round(jimage.load_rgba(str(path)) * 255).astype(np.int64)
    np.testing.assert_array_equal(pil[..., 0], np.minimum(samples, 255))
    return got


# ---- the repairs: None where libtiff or PIL fails ---------------------------

NONE_FIRST = {
    "predictor 3 on 8-bit grey, Deflate": ti.tiff_bytes(
        RGB[..., :1], compression=8, predictor=3),
    "predictor 3 on 8-bit RGB, LZW": ti.tiff_bytes(RGB, compression=5,
                                                   predictor=3),
    "predictor 3 on 16-bit grey, LZMA": ti.tiff_bytes(
        WIDE[..., :1], 16, compression=34925, predictor=3),
    "predictor 3 on signed 16-bit, Adobe Deflate": ti.tiff_bytes(
        WIDE[..., :1] // 2, 16, compression=32946, predictor=3,
        sample_format=2),
    "predictor 3 on 32-bit integers, ZSTD": ti.tiff_bytes(
        WIDE[..., :1], 32, compression=50000, predictor=3),
    "predictor 3 on 12-bit grey, Deflate": ti.tiff_bytes(
        GREY12, 12, compression=8, predictor=3),
    "predictor 2 on 12-bit grey, LZW": ti.tiff_bytes(GREY12, 12,
                                                     compression=5,
                                                     predictor=2),
    "predictor 2 at 4 bits, Deflate": ti.tiff_bytes(
        RGB[..., :1] >> 4, 4, compression=8, predictor=2),
    "predictor 2 at 1 bit, ZSTD": ti.tiff_bytes(
        RGB[..., :1] >> 7, 1, compression=50000, predictor=2),
    "predictor 4, Deflate": ti.tiff_bytes(RGB, compression=8, predictor=4),
    "predictor 0, LZW": ti.tiff_bytes(RGB, compression=5, predictor=0),
    # PIL's libtiff has no WebP codec ("WEBP compression support is not
    # configured")
    "WebP in TIFF": ti.tiff_bytes(RGB, compression=50001, chunks=[
        b"RIFF" + bytes(40)]),
}
NONE_ALREADY = {
    "12-bit grey, big-endian": ti.tiff_bytes(GREY12, 12, order=">"),
    "12-bit grey, min-is-white": ti.tiff_bytes(GREY12, 12, photometric=0),
    "12-bit grey and alpha": ti.tiff_bytes(R.integers(0, 4096, (9, 13, 2)),
                                           12, extra=[2]),
    "12-bit RGB": ti.tiff_bytes(R.integers(0, 4096, (9, 13, 3)), 12),
    "12-bit grey, fill order 2": ti.tiff_bytes(GREY12, 12, fill_order=2),
    "12-bit signed grey": ti.tiff_bytes(GREY12, 12, sample_format=2),
    "16-bit floats under predictor 3": ti.tiff_bytes(
        WIDE[..., :1], 16, compression=8, predictor=3, sample_format=3),
    "64-bit floats under predictor 3": ti.tiff_bytes(
        FLOATS, 32, compression=8, sample_format=3, chunks=[bytes(16)],
        extra_tags=((258, 3, [64]), (317, 3, [3]))),
}


@pytest.mark.parametrize("case", list(NONE_FIRST))
def test_predictors_libtiff_refuses_are_none_as_in_jax(case, tmp_path):
    """libtiff's PredictorSetup fails the first strip (or, for WebP, its
    missing codec), PIL raises and the JAX package gives None; the port
    raised ``NotImplementedError``."""
    as_jax(tmp_path, "x.tif", NONE_FIRST[case])
    assert image.load_rgba(str(tmp_path / "x.tif")) is None


@pytest.mark.parametrize("case", list(NONE_ALREADY))
def test_keys_pil_has_no_mode_for_are_none_as_in_jax(case, tmp_path):
    """PIL's OPEN_INFO has no key for these: "cannot identify image
    file", None in both."""
    as_jax(tmp_path, "x.tif", NONE_ALREADY[case])
    assert image.load_rgba(str(tmp_path / "x.tif")) is None


# ---- BigTIFF ----------------------------------------------------------------

def _pil_image(mode: str):
    if mode == "F":
        return Image.fromarray(FLOATS[..., 0])
    if mode == "I":
        return Image.fromarray(WIDE[..., 0].astype(np.int32) - 30000)
    if mode == "I;16":
        return Image.frombytes("I;16", (13, 9), WIDE[..., 0].astype(
            "<u2").tobytes())
    if mode == "1":
        return Image.fromarray(RGB[..., 0] > 120)
    if mode == "P":
        return Image.fromarray(RGB).quantize(7)
    if mode in ("RGBA", "CMYK"):
        return Image.frombytes(mode, (13, 9), np.concatenate(
            [RGB, WIDE[..., :1].astype(np.uint8)], -1).tobytes())
    return Image.fromarray(RGB).convert(mode)


def _big_cases():
    cases = []
    for mode in ("1", "L", "LA", "P", "RGB", "RGBA", "CMYK", "YCbCr", "I",
                 "F", "I;16"):
        for codec in ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits",
                      "lzma", "zstd", "jpeg", "group4", "group3",
                      "tiff_ccitt"):
            if (codec in ("group4", "group3", "tiff_ccitt")) != (mode == "1"):
                if not (mode == "1" and codec in ("raw", "tiff_lzw",
                                                  "packbits")):
                    continue
            if codec == "jpeg" and mode not in ("L", "LA", "RGB", "CMYK",
                                                "YCbCr"):
                continue
            cases.append((mode, codec))
    return cases


@pytest.mark.parametrize("offsets", [16, 4], ids=["LONG8", "LONG"])
@pytest.mark.parametrize("mode, codec", _big_cases())
def test_bigtiff_of_every_mode_and_compression_as_jax(mode, codec, offsets,
                                                      tmp_path):
    """PIL's classic file made a BigTIFF (``torch_images.bigtiff_of``: a
    16-byte header, 8-byte counts and offsets, values of up to 8 bytes
    inline), read as the JAX package reads it; I;16 as the named
    deviation."""
    data = ti.bigtiff_of(pil_tiff(_pil_image(mode), compression=codec),
                         offsets)
    assert data[:4] == b"II\x2b\x00"
    if mode == "I;16":
        deviation(tmp_path, data, 8)
    else:
        held(tmp_path, "x.tif", data)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "F", "I", "CMYK"])
def test_pil_written_bigtiff_as_jax(mode, tmp_path):
    held(tmp_path, "x.tif", pil_tiff(_pil_image(mode), big_tiff=True))


BIG_LAYOUTS = {
    "one strip": {},
    "strips of 4 rows (2 LONG offsets inline, 3 LONG8 out of line)": {
        "rows_per_strip": 4},
    "strips of 5 rows (two LONG offsets in 8 bytes)": {"rows_per_strip": 5,
                                                       "offset_type": 4},
    "16x16 tiles": {"tile": (16, 16)},
    "separate planes in 32x16 tiles": {"tile": (32, 16), "planar": 2},
}


@pytest.mark.parametrize("codec", [1, 5, 8, 32773, 34925, 50000])
@pytest.mark.parametrize("layout", list(BIG_LAYOUTS))
def test_hand_made_bigtiff_strips_and_tiles_as_jax(layout, codec,
                                                   tmp_path):
    held(tmp_path, "x.tif", ti.tiff_bytes(RGB, compression=codec, big=True,
                                          **{"offset_type": 16,
                                             **BIG_LAYOUTS[layout]}))


def _header(data: bytes, at: int, patch: bytes) -> bytes:
    return data[:at] + patch + data[at + len(patch):]


BIG_HEADERS = {
    # PIL reads offset size and zero word never; libtiff checks both
    "offset size 4, uncompressed": (False, 4, b"\x04\x00"),
    "offset size 4, Deflate": (True, 4, b"\x04\x00"),
    "a word after it of 1, uncompressed": (False, 6, b"\x01\x00"),
    "a word after it of 1, LZW": (True, 6, b"\x01\x00"),
    # the first IFD at 0 (PIL: no more images) and past 2**63 (PIL cannot
    # seek to it)
    "the first IFD at 0": (False, 8, bytes(8)),
    "the first IFD at 2**63": (False, 8, struct.pack("<Q", 1 << 63)),
    "the first IFD past the end": (False, 8, struct.pack("<Q", 1 << 40)),
}


@pytest.mark.parametrize("case", list(BIG_HEADERS))
def test_bigtiff_header_checks_as_jax(case, tmp_path):
    compressed, at, patch = BIG_HEADERS[case]
    data = ti.tiff_bytes(RGB, compression=8 if compressed else 1, big=True)
    as_jax(tmp_path, "x.tif", _header(data, at, patch))


def test_big_endian_bigtiff_is_read_by_pil_as_classic(tmp_path):
    """PIL takes a BigTIFF by the header's third byte, 0 in ``MM 00 2B``:
    it reads the big-endian file as a classic one whose first IFD lies at
    the offset size's bytes (``00 08 00 00``), and cannot identify it."""
    data = ti.tiff_bytes(RGB, compression=8, big=True, order=">")
    as_jax(tmp_path, "x.tif", data)
    assert image.load_rgba(str(tmp_path / "x.tif")) is None


def test_classic_file_damaged_to_magic_43_is_compared(tmp_path):
    """A classic little-endian file whose 42 became 43: PIL reads a
    BigTIFF header and a first IFD at the classic file's bytes 8-15,
    past the end or past 2**63 here (the damage test's deviation before:
    refused)."""
    for rows in (None, 3):
        data = pil_tiff(Image.fromarray(RGB), tiffinfo={278: rows or 9})
        as_jax(tmp_path, "x.tif", _header(data, 2, b"\x2b"))
        assert image.load_rgba(str(tmp_path / "x.tif")) is None


def test_tag_values_past_2_63_end_pil_reading(tmp_path):
    """An entry whose values lie at an offset of 2**63 or more makes PIL's
    seek raise (None); one past the end but under it stops PIL's reading
    of the IFD there."""
    data = bytearray(ti.tiff_bytes(RGB, rows_per_strip=2, big=True,
                                   offset_type=16))
    at = struct.unpack_from("<Q", data, 8)[0]
    n = struct.unpack_from("<Q", data, at)[0]
    for i in range(n):
        tag = struct.unpack_from("<H", data, at + 8 + 20 * i)[0]
        if tag == 279:                    # StripByteCounts, out of line
            entry = at + 8 + 20 * i
    for offset, none in ((1 << 63, True), (1 << 62, False)):
        damaged = bytes(data[:entry + 12]) + struct.pack("<Q", offset) + \
            bytes(data[entry + 20:])
        as_jax(tmp_path, "x.tif", damaged)
        assert (image.load_rgba(str(tmp_path / "x.tif")) is None) == none


def _entry(data: bytes, tag: int) -> int:
    """The offset of ``tag``'s entry in the first IFD (classic or
    BigTIFF, little-endian)."""
    big = data[2] == 43
    at = struct.unpack_from("<Q" if big else "<I", data, 8 if big else 4)[0]
    head, entry = (8, 20) if big else (2, 12)
    n = struct.unpack_from("<Q" if big else "<H", data, at)[0]
    for i in range(n):
        if struct.unpack_from("<H", data, at + head + entry * i)[0] == tag:
            return at + head + entry * i
    raise KeyError(tag)


def _patched(data: bytes, tag: int, count=None, value=None) -> bytes:
    """``data`` with ``tag``'s count or its first inline value set."""
    big = data[2] == 43
    out = bytearray(data)
    at = _entry(data, tag)
    if count is not None:
        struct.pack_into("<Q" if big else "<I", out, at + 4, count)
    if value is not None:
        struct.pack_into("<H", out, at + (12 if big else 8), value)
    return bytes(out)


GREY_DEFLATE = ti.tiff_bytes(RGB[..., :1], compression=8, sample_format=1)
DIRECTORY = {
    # libtiff fetches these without recovery: no values fail it
    **{f"{name} without values, Deflate": (GREY_DEFLATE, tag, dict(count=0))
       for name, tag in (("BitsPerSample", 258), ("SamplesPerPixel", 277),
                         ("RowsPerStrip", 278), ("PlanarConfiguration", 284),
                         ("SampleFormat", 339))},
    # ... and values past the end of the file
    "SampleFormat's values past the end, Deflate": (GREY_DEFLATE, 339, dict(
        count=5000)),
    # a value a sample of Compression is read; Photometric of another
    # count is dropped with a warning
    "two Compression values, Deflate": (GREY_DEFLATE, 259, dict(count=2)),
    "two Photometric values, Deflate": (GREY_DEFLATE, 262, dict(count=2)),
    # TIFFSetField's refusals
    "PlanarConfiguration 3, Deflate": (GREY_DEFLATE, 284, dict(value=3)),
    "RowsPerStrip 0, Deflate": (GREY_DEFLATE, 278, dict(value=0)),
    # PIL's raw decoder: tiles of no rows
    "RowsPerStrip 0, uncompressed": (ti.tiff_bytes(
        RGB[..., :1], rows_per_strip=5), 278, dict(value=0)),
}


@pytest.mark.parametrize("big", [False, True], ids=["classic", "BigTIFF"])
@pytest.mark.parametrize("case", list(DIRECTORY))
def test_libtiff_and_pil_directory_rules_as_jax(case, big, tmp_path):
    """Entries libtiff reads otherwise than PIL (both views of one IFD)."""
    data, tag, patch = DIRECTORY[case]
    if big:
        data = ti.bigtiff_of(data)
    as_jax(tmp_path, "x.tif", _patched(data, tag, **patch))


@pytest.mark.parametrize("big", [False, True], ids=["classic", "BigTIFF"])
@pytest.mark.parametrize("entries", [4096, 4097])
def test_libtiff_reads_no_more_than_4096_entries(entries, big, tmp_path):
    """A Deflate file's IFD moved to the end and padded with empty
    entries (tag 0, type 0: PIL skips them): libtiff's sanity check
    fails a directory of more than 4,096 entries."""
    data = ti.tiff_bytes(RGB, compression=8, big=big)
    head, entry, word = (8, 20, "Q") if big else (2, 12, "I")
    at = struct.unpack_from("<" + word, data, 8 if big else 4)[0]
    n = struct.unpack_from("<" + ("Q" if big else "H"), data, at)[0]
    ifd = (struct.pack("<" + ("Q" if big else "H"), entries)
           + data[at + head:at + head + entry * n]
           + bytes(entry * (entries - n) + (8 if big else 4)))
    moved = bytearray(data + ifd)
    struct.pack_into("<" + word, moved, 8 if big else 4, len(data))
    as_jax(tmp_path, "x.tif", bytes(moved))
    assert (image.load_rgba(str(tmp_path / "x.tif")) is None) == (
        entries > 4096)


def test_rows_libtiff_and_pil_read_apart_are_none_as_in_jax(tmp_path):
    """An IFD PIL stops reading early (a tag's values past the end) and
    libtiff reads whole, so the two lay a strip out differently: PIL's
    decoder checks libtiff's row against its unpacker's and fails."""
    data = ti.bigtiff_of(ti.tiff_bytes(np.concatenate(
        [RGB, RGB[..., :1]], -1), photometric=5, compression=8))
    damaged = _patched(data, 262, count=1 << 33)
    as_jax(tmp_path, "x.tif", damaged)
    assert image.load_rgba(str(tmp_path / "x.tif")) is None


@pytest.mark.parametrize("layout", ["one strip", "strips"])
def test_uncompressed_offsets_as_pils_raw_decoder_reads_them(layout,
                                                             tmp_path):
    """PIL's raw decoder takes the last offset of a strip that covers the
    image, and reads every other offset as a tile of the next cell, in the
    offsets' order."""
    rps = 9 if layout == "one strip" else 5
    chunks = [RGB[:rps].tobytes(), RGB[rps:].tobytes()] if rps < 9 else [
        bytes(13 * 9 * 3)]
    chunks.append(RGB[::-1][:rps].tobytes())
    held(tmp_path, "x.tif", ti.tiff_bytes(RGB, rows_per_strip=rps,
                                          chunks=chunks))


@pytest.mark.parametrize("big", [False, True], ids=["classic", "BigTIFF"])
def test_uncompressed_edge_tile_needs_its_last_row_to_the_edge(big,
                                                               tmp_path):
    """PIL's raw decoder reads an edge tile's last row only to the
    image's edge: a file cut in the rest of that row decodes, one cut a
    byte into the image does not."""
    data = ti.tiff_bytes(RGB, tile=(16, 16), big=big)
    need = 8 * 16 * 3 + 13 * 3             # the tile's bytes PIL reads
    cut = len(data) - 16 * 16 * 3 + need
    held(tmp_path, "x.tif", data[:cut])
    as_jax(tmp_path, "x.tif", data[:cut - 1])
    assert image.load_rgba(str(tmp_path / "x.tif")) is None


@pytest.mark.parametrize("big", [False, True], ids=["classic", "BigTIFF"])
def test_a_tile_is_inflated_whole_past_the_image(big, tmp_path):
    """libtiff inflates a whole tile, the rows below the image too: a
    Deflate tile whose Adler-32 is wrong fails, where the image's own rows
    come out whole."""
    data = ti.tiff_bytes(RGB, compression=8, tile=(16, 16), big=big)
    held(tmp_path, "x.tif", data)
    damaged = data[:-1] + bytes([data[-1] ^ 1])   # the tile's last byte
    as_jax(tmp_path, "x.tif", damaged)
    assert image.load_rgba(str(tmp_path / "x.tif")) is None


# ---- the floating-point predictor -------------------------------------------

@pytest.mark.parametrize("codec", ["tiff_lzw", "tiff_adobe_deflate", "lzma",
                                   "zstd"])
@pytest.mark.parametrize("size", [(13, 9), (53, 37)])
def test_pil_written_predictor_3_as_jax(codec, size, tmp_path):
    w, h = size
    f = (np.random.default_rng(w).random((h, w)) * 300 - 40).astype(
        np.float32)
    f[0, :3] = (np.nan, np.inf, 1e20)
    held(tmp_path, "x.tif", pil_tiff(Image.fromarray(f), compression=codec,
                                     tiffinfo={317: 3}))


@pytest.mark.parametrize("big", [False, True], ids=["classic", "BigTIFF"])
@pytest.mark.parametrize("layout", [{}, {"rows_per_strip": 4},
                                    {"tile": (16, 32)}],
                         ids=["one strip", "strips", "tiles"])
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("codec", list(PREDICTED))
def test_hand_made_predictor_3_as_jax(codec, order, layout, big, tmp_path):
    """libtiff's ``fpAcc``: each row's bytes summed, then the byte planes,
    most significant first, gathered; of a big-endian file PIL reads the
    host-order samples libtiff gives as big-endian, so byte-swapped. (A
    big-endian BigTIFF PIL cannot identify: None in both.)"""
    data = ti.tiff_bytes(FLOATS, 32, sample_format=3,
                         compression=PREDICTED[codec], predictor=3,
                         order=order, big=big, **layout)
    if big and order == ">":
        as_jax(tmp_path, "x.tif", data)
        assert image.load_rgba(str(tmp_path / "x.tif")) is None
    else:
        held(tmp_path, "x.tif", data)


def test_predictor_3_is_truncated_and_clipped_as_pil_converts_f(tmp_path):
    f = np.array([[[-5.5], [0.0], [0.99], [1.0], [254.9], [255.0], [300.0],
                   [np.nan]]], np.float32)
    got = held(tmp_path, "x.tif", ti.tiff_bytes(f, 32, sample_format=3,
                                                compression=8, predictor=3))
    assert got[0, :, 0].tolist() == [0, 0, 0, 1, 254, 255, 255, 0]


# ---- 12-bit grey -------------------------------------------------------------

@pytest.mark.parametrize("layout", [{}, {"rows_per_strip": 4},
                                    {"tile": (16, 16)}],
                         ids=["one strip", "strips", "tiles"])
@pytest.mark.parametrize("codec", [1, 5, 8, 32946, 32773, 34925, 50000])
def test_12bit_grey_tiff_is_the_named_deviation(codec, layout, tmp_path):
    """PIL opens 12-bit grey as ``I;16`` (raw mode ``I;12``, the samples'
    bits most significant first, each row ending on a byte) and clips it
    at 255; the port keeps each sample's top 8 bits (``v >> 4``), a
    12-bit map's high byte."""
    deviation(tmp_path, ti.tiff_bytes(GREY12, 12, compression=codec,
                                      **layout), 4)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_12bit_grey_turns_by_its_orientation(orientation, tmp_path):
    """PIL memory-maps no ``I;12`` strip (its raw mode is not its mode),
    so the single-strip file at 5-8 is read and turned, not refused."""
    got = deviation(tmp_path, ti.tiff_bytes(GREY12, 12, extra_tags=(
        (274, 3, [orientation]),)), 4)
    assert got.shape[:2] == ((13, 9) if orientation > 4 else (9, 13))


UNMAPPED = {
    "16-bit RGBA": (WIDE, 16, 2, [2]),
    "16-bit CMYK": (WIDE, 16, 5, None),
    "8-bit grey, min-is-white": (RGB[..., :1], 8, 0, None),
    "4-bit palette": (RGB[..., :1] >> 4, 4, 3, None),
}


@pytest.mark.parametrize("orientation", [5, 6, 7, 8])
@pytest.mark.parametrize("case", list(UNMAPPED))
def test_single_strips_pil_does_not_map_turn_as_jax(case, orientation,
                                                    tmp_path):
    """PIL memory-maps a one-strip file only where its raw mode is its
    mode (``RGBA;16L``, ``CMYK;16L``, ``L;I`` and ``P;4`` are not): these
    are read and turned, as the port refused them before."""
    samples, bits, photo, extra = UNMAPPED[case]
    cmap = [(i * 4111) % 65536 for i in range(48)] if photo == 3 else None
    held(tmp_path, "x.tif", ti.tiff_bytes(
        samples, bits, photometric=photo, extra=extra, colormap=cmap,
        extra_tags=((274, 3, [orientation]),)))


def test_12bit_big_tiff_and_odd_widths(tmp_path):
    for w in (1, 2, 3, 7):
        deviation(tmp_path, ti.tiff_bytes(GREY12[:, :w], 12, big=True,
                                          compression=5), 4)


# ---- separate 16-bit planes, uncompressed -----------------------------------

PLANAR = {"RGB": (2, 3, None), "RGBA": (2, 4, [2]),
          "RGBA without ExtraSamples": (2, 4, None), "CMYK": (5, 4, None)}


@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
@pytest.mark.parametrize("layout", [{}, {"rows_per_strip": 4},
                                    {"rows_per_strip": 1},
                                    {"tile": (16, 16)}],
                         ids=["one strip", "strips", "rows", "tiles"])
@pytest.mark.parametrize("kind", list(PLANAR))
def test_uncompressed_planar_16bit_as_jax(kind, layout, order, tmp_path):
    photo, spp, extra = PLANAR[kind]
    held(tmp_path, "x.tif", ti.tiff_bytes(
        WIDE[..., :spp], 16, photometric=photo, planar=2, extra=extra,
        order=order, **layout))


def test_planar_16bit_reads_each_plane_as_bytes(tmp_path):
    """PIL reads each plane through the one letter of ``RGB;16L`` it takes
    as the plane's raw mode: red row 0 is the low and high bytes of the
    first samples, its second half in row 1 (copied, not fixed)."""
    got = held(tmp_path, "x.tif", ti.tiff_bytes(WIDE[..., :3], 16,
                                                planar=2))
    plane = WIDE[..., 0].astype("<u2").tobytes()
    np.testing.assert_array_equal(got[..., 0].reshape(-1),
                                  np.frombuffer(plane, np.uint8)[:13 * 9])


@pytest.mark.parametrize("extra", [[0], [1]], ids=["RGBX", "RGBa"])
def test_planar_16bit_letters_pil_cannot_read_are_none(extra, tmp_path):
    """``RGBX;16L``'s ``X`` and ``RGBa;16L``'s ``a`` are no raw mode of
    PIL's mode: None in both."""
    as_jax(tmp_path, "x.tif", ti.tiff_bytes(WIDE, 16, planar=2, extra=extra))
    assert image.load_rgba(str(tmp_path / "x.tif")) is None


def test_planar_16bit_with_a_strip_past_the_last_plane_is_none(tmp_path):
    data = ti.tiff_bytes(WIDE[..., :3], 16, planar=2, rows_per_strip=9,
                         chunks=[WIDE[..., i].astype("<u2").tobytes()
                                 for i in (0, 1, 2, 0)])
    as_jax(tmp_path, "x.tif", data)
    assert image.load_rgba(str(tmp_path / "x.tif")) is None


# ---- still refused -------------------------------------------------------------

def _still_refused():
    lab = pil_tiff(Image.fromarray(RGB).convert("LAB"))
    return {
        "CIELab": (lab, "CIELab"),
        "CIELab BigTIFF, LZW": (ti.bigtiff_of(pil_tiff(Image.fromarray(
            RGB).convert("LAB"), compression="tiff_lzw")), "CIELab"),
        "old-style LZW": (ti.tiff_bytes(RGB, compression=5, chunks=[
            b"\x00\x01" + bytes(30)]), "old-style LZW"),
        "old-style JPEG BigTIFF": (ti.tiff_bytes(
            RGB, photometric=6, compression=6, big=True,
            chunks=[ti.jpeg_bytes(RGB)]), "old-style JPEG"),
        "JPEG in separate planes": (ti.tiff_bytes(
            RGB, compression=7, planar=2,
            chunks=[ti.jpeg_bytes(RGB, "L")] * 3), "separate planes"),
        "12-bit JPEG": (ti.tiff_bytes(GREY12, 12, compression=7, chunks=[
            ti.jpeg_bytes(RGB, "L")]), "12-bit JPEG"),
        "a mapped single-strip BigTIFF at orientation 6": (pil_tiff(
            Image.fromarray(RGB).convert("L"), big_tiff=True,
            tiffinfo={274: 6}), "width and height swapped"),
        "YCbCr LZW subsampled 2x2": (ti.tiff_bytes(
            RGB, photometric=6, compression=5, big=True,
            extra_tags=((530, 3, [2, 2]),)), "subsampling"),
        "CCITT RLEW": (pil_tiff(Image.fromarray(RGB[..., 0] > 99),
                                compression="tiff_raw_16"), "RLEW"),
    }


@pytest.mark.parametrize("case", list(_still_refused()))
def test_flavours_still_refused_name_file_and_flavour(case, tmp_path):
    data, what = _still_refused()[case]
    path = tmp_path / "my_texture.tif"
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match=f"my_texture.*{what}"):
        image.load_rgba(str(path))


# ---- the committed fixtures and the card's maps -----------------------------

FIXTURES = ["small_pred3.tif", "small_pred3_be_tiles.tif", "small_big.tif",
            "small_big_deflate_tiles.tif", "grey12.tif",
            "small_planar16.tif"]


@pytest.mark.parametrize("name", FIXTURES)
def test_small_fixtures_decode_as_jax(name, tmp_path):
    with open(os.path.join(DATA, name), "rb") as f:
        data = f.read()
    got = (deviation(tmp_path, data, 4) if name.startswith("grey12")
           else held(tmp_path, name, data))
    assert got.shape == (9, 13, 4)


with open(os.path.join(DATA, "tiff_float_big_map_digests.json")) as _f:
    MAP_DIGESTS = json.load(_f)


def test_map_digests_name_every_map():
    assert sorted(MAP_DIGESTS) == sorted(fx.TIFF_FLOAT_BIG_MAPS)


@pytest.mark.parametrize("name", sorted(fx.TIFF_FLOAT_BIG_MAPS))
def test_maps_decode_to_recorded_digests(name, tmp_path):
    """The maps ``chip_smoke.py`` makes and times are the files
    ``tests/torch_data/tiff_float_big_map_digests.json`` records, and the
    port decodes each to PIL's recorded decode (the 12-bit ones to the
    named deviation's image), which ``chip_smoke.py`` holds the card
    machine's decode to."""
    want = MAP_DIGESTS[name]
    data, _ = fx.tiff_float_big_map(name)
    assert hashlib.sha256(data).hexdigest() == want["file_sha256"]
    path = tmp_path / name
    path.write_bytes(data)
    got = image.load_rgba8(str(path))
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["rgba_sha256"]


# ---- scenes -----------------------------------------------------------------

def pred3_and_big(tmp_path):
    """Paths of a 64x48 predictor-3 float roughness map (Adobe Deflate,
    8-row strips) and a 40x32 BigTIFF RGB normal map (Deflate, tiles)."""
    rough = tmp_path / "rough.tif"
    grey = fx.procedural_rgb(64, 48, 5)[..., 1:2].astype(np.float32)
    rough.write_bytes(ti.tiff_bytes(grey * np.float32(0.9) + np.float32(
        10.25), 32, sample_format=3, compression=32946, predictor=3,
        rows_per_strip=8))
    normal = tmp_path / "normal.tif"
    normal.write_bytes(ti.tiff_bytes(fx.normal_map(32)[:, :32], 8,
                                     compression=8, tile=(16, 16), big=True))
    return str(rough), str(normal)


def test_pred3_and_bigtiff_mapped_hier_trace_matches_jax_under_one_key(
        tmp_path):
    """The glossy wall of ``normal_mapped_wall`` with the two maps, the port
    through ``"hier"`` (the BVH walk the card sessions run; its plain
    version here) against the JAX package's dense trace (rtol 1e-4 /
    atol 1e-6)."""
    rough, normal = pred3_and_big(tmp_path)
    for path in (rough, normal):
        with open(path, "rb") as f:
            held(tmp_path, "x.tif", f.read())
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    ro, rd = (np.array(a) for a in jax_camera_rays(jsc.camera(), 16, 16))
    want = jengine.trace_radiance(
        jsc.compile(), jnp.asarray(ro), jnp.asarray(rd), jax.random.key(5),
        jsc.trace_depth, backend="dense")
    got = engine.trace_radiance(
        to_port_scene(jsc).compile("cpu"), torch.from_numpy(ro),
        torch.from_numpy(rd), rng.key(5), jsc.trace_depth, backend="hier")
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


_NO_JAX_TIFF = r"""
import importlib.util
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "PIL"):
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, Refuse())
sys.path.insert(0, sys.argv[1])
import os
import numpy as np
import pathtracing_spectrum_tpu_torch as pt
from pathtracing_spectrum_tpu_torch.utils import image

spec = importlib.util.spec_from_file_location(
    "fx", os.path.join(sys.argv[1], "tools", "make_torch_fixtures.py"))
fx = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fx)
ti = fx._images_module()
tmp, assets = sys.argv[2], os.path.join(sys.argv[1], "assets")
data_dir = os.path.join(sys.argv[1], "tests", "torch_data")
for name in sys.argv[3].split(","):
    assert image.load_rgba8(os.path.join(data_dir, name)).shape == (9, 13, 4)
rough = os.path.join(tmp, "r.tif")
with open(rough, "wb") as f:
    f.write(ti.tiff_bytes(fx.procedural_rgb(40, 24, 3)[..., 1:2].astype(
        np.float32), 32, sample_format=3, compression=50000, predictor=3,
        big=True))
normal = os.path.join(tmp, "n.tif")
with open(normal, "wb") as f:
    f.write(ti.tiff_bytes(fx.procedural_rgb(32, 32, 2).astype(np.int64)
                          * 257, 16, planar=2, rows_per_strip=8))
sc = pt.Scene()
sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
sc.spectrum_materials = [pt.SpectrumMaterial("body", [0.7, 0.75, 0.8, 0.7]),
                         pt.SpectrumMaterial("emitter", [1.0] * 4)]
sc.resolution = (12, 8)
obj = sc.load_object(os.path.join(assets, "sphere.obj"))
sc.set_material(0, 0, pt.Material(
    type=pt.MaterialType.GLOSSY, spectrum_mat_id=0, temperature=80.0,
    roughness=0.4, roughness_tex_file=rough))
sc.set_normal_texture(0, 0, normal)
obj.set_location([0.0, 0.0, 3.0])
box = sc.load_object(os.path.join(assets, "cornell_box.obj"))
for i, el in enumerate(box.elements):
    hot = el.name == "light"
    sc.set_material(1, i, pt.Material(temperature=400.0 if hot else 15.0,
                                      spectrum_mat_id=1 if hot else 0))
sc.set_camera([0.0, 0.0, -1.0], [0.0, 0.0, 0.0])
sc.camera_fovy = 55.0
data = sc.compile("cpu")
assert tuple(data.textures.shape) == (2, 32, 40, 4), data.textures.shape
img = pt.RenderSession(sc, "cpu", seed=1).run(2, batch=2)
assert img.shape == (8, 12, 4) and np.isfinite(img).all() and img.mean() > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "PIL"))
assert not bad, bad
print("ok")
"""


def test_pred3_bigtiff_mapped_render_imports_neither_jax_nor_pil(tmp_path):
    """The TIFF reader and the maps' builders load without jax and PIL."""
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_TIFF, REPO, str(tmp_path),
         ",".join(FIXTURES)], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
