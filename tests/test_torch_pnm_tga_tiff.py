"""The port's readers of the files PIL's own writers make from modes 1, I,
I;16, F, CMYK and YCbCr, against the JAX package's ``load_rgba`` (PIL
12.1), bit for bit (tolerance 0): binary PNM (P4; P5 and P6 at every
maxval, through PIL's raw decoder or its PpmDecoder; Pf), 1-bit TGA, and
CMYK, mode I and YCbCr TIFF, each as PIL writes it at sizes 1x1 to 64x64
and as a hand-built file (both TIFF byte orders, four compressions,
separate planes, tiles, predictor 2), and damaged files, None in both.

The named deviation: a P5 with a maxval above 255 (PIL's mode I) keeps
the high byte of each sample scaled to 65535, where PIL clips at 255.

Then the two repairs (an uncompressed YCbCr TIFF, which PIL reads as 4
bytes a pixel past the end of its strip, and a run-length 1-bit TGA, which
PIL's TgaRleDecode never completes: None in both); libtiff's YCbCr to RGB
conversion held over every (Cb, Cr) pair at several Y levels and two
ReferenceBlackWhite settings; the flavours still refused; a scene with a
CMYK TIFF roughness map and a YCbCr TIFF normal map compiled and traced
under one key against the JAX package (rtol 1e-4 / atol 1e-6, as
``tests/test_torch_spectral.py`` states it); and a render from those maps
in a process that refuses to import jax and PIL.
"""

import importlib.util
import os
import struct
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from pathtracing_spectrum_tpu import MaterialType  # noqa: E402
from pathtracing_spectrum_tpu.utils import image as jimage  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import image  # noqa: E402

import torch_images as ti  # noqa: E402
from scene_helpers import cornell_scene  # noqa: E402
from test_torch_readers import held, pil_file, pil_image  # noqa: E402
from test_torch_scene import assert_fields_equal, to_port_scene  # noqa: E402,E501
from test_torch_spectral import assert_same, trace_both  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_torch_fixtures", os.path.join(REPO, "tools",
                                        "make_torch_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

SIZES = [(1, 1), (5, 7), (2, 3), (37, 29), (64, 64)]     # (W, H)
SIZE_IDS = [f"{w}x{h}" for w, h in SIZES]


def none_in_both(tmp_path, name: str, data: bytes) -> None:
    """PIL refuses the file, and the port gives None."""
    path = tmp_path / name
    path.write_bytes(data)
    assert jimage.load_rgba(str(path)) is None, "PIL reads this case"
    assert image.load_rgba(str(path)) is None


def refused(tmp_path, data: bytes, what: str) -> None:
    path = tmp_path / "my_texture.tif"
    path.write_bytes(data)
    with pytest.raises(NotImplementedError, match=f"my_texture.*{what}"):
        image.load_rgba(str(path))


# ---- PNM -------------------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("mode", ["1", "L", "RGB", "F"])
def test_pil_written_pnm_decodes_as_jax(mode, size, tmp_path):
    """P4, P5 and P6 at maxval 255 and Pf, as PIL writes modes 1, L, RGB
    and F."""
    img = pil_image(mode, *size, seed=3)
    data = pil_file(img, "PPM")
    assert data[:2] == {"1": b"P4", "L": b"P5", "RGB": b"P6",
                        "F": b"Pf"}[mode]
    held(tmp_path, "x.pnm", data)


def pnm(magic: bytes, w: int, h: int, maxval, body: bytes,
        sep: bytes = b"\n") -> bytes:
    head = magic + sep + b"%d %d" % (w, h)
    if maxval is not None:
        head += sep + (maxval if isinstance(maxval, bytes)
                       else b"%d" % maxval)
    return head + sep + body


def _pnm_cases():
    rng = np.random.default_rng(5)
    cases = {}
    for w in (1, 7, 8, 9, 17):
        rows = rng.integers(0, 256, (3, (w + 7) // 8), np.uint8)
        cases[f"P4-{w}"] = pnm(b"P4", w, 3, None, rows.tobytes())
    cases["P4-comments"] = (b"P4 # a bitmap\n#more\r9\t2 # h\n"
                            + bytes([0xA5, 0x80, 0x3C, 0x7F]))
    cases["P4-trailing"] = pnm(b"P4", 9, 2, None, bytes(range(40)))
    for maxval in (1, 2, 15, 100, 254):
        cases[f"P5-{maxval}"] = pnm(b"P5", 7, 5, maxval, rng.integers(
            0, 256, 35, np.uint8).tobytes())
    for maxval in (1, 100, 254, 255, 256, 1000, 4095, 65534, 65535):
        k = 1 if maxval < 256 else 2
        samples = rng.integers(0, 256 ** k, (4, 6, 3))
        samples[0, :3] = [0, maxval, min(maxval + 1, 256 ** k - 1)]
        cases[f"P6-{maxval}"] = pnm(b"P6", 6, 4, maxval, samples.astype(
            ">u2" if k == 2 else np.uint8).tobytes())
    half = np.array([0, 1, 2, 3], ">u2")        # values / 2 * 255 ties
    cases["P6-2-ties"] = pnm(b"P6", 4, 1, 2, np.repeat(half, 3).astype(
        np.uint8).tobytes())
    cases["P6-510-ties"] = pnm(b"P6", 4, 1, 510, np.repeat(
        np.array([1, 3, 5, 255], ">u2"), 3).tobytes())
    cases["P6-1000-trailing"] = cases["P6-1000"] + b"\x07" * 11
    special = np.array([[0.0, -0.0, 1.5, 254.99], [255.0, 255.5, 1e30, -1e30],
                        [np.inf, -np.inf, np.nan, 1e-42]], np.float32)
    for scale in (b"-1.0", b"-2.5", b"1", b"0.5", b"1_0", b"+3e2"):
        order = "<" if scale.startswith(b"-") else ">"
        cases[f"Pf-{scale.decode()}"] = pnm(b"Pf", 4, 3, scale,
                                            special.astype(order + "f4")
                                            .tobytes())
    cases["Pf-noise"] = pnm(b"Pf", 9, 6, b"-1", (rng.random((6, 9)) * 600
                                                - 150).astype("<f4")
                            .tobytes())
    return cases


PNM_CASES = _pnm_cases()


@pytest.mark.parametrize("case", sorted(PNM_CASES))
def test_pnm_decodes_as_jax(case, tmp_path):
    """Hand-built P4, P5 at maxval below 255, P6 at every kind of maxval
    (PpmDecoder's rounding, half to even, and its clip of samples above
    maxval), and Pf in both byte orders with NaN, infinities, -0.0 and
    denormals; comments, tabs and bytes after the pixels."""
    held(tmp_path, "x.ppm", PNM_CASES[case])


@pytest.mark.parametrize("case", ["pil-I", "pil-I;16", "maxval-256",
                                  "maxval-300", "maxval-1000",
                                  "maxval-4095", "maxval-65534"])
def test_16bit_grey_pnm_is_the_named_deviation(case, tmp_path):
    """A P5 with a maxval above 255 is PIL's mode I: samples scaled to
    65535 (PIL's raw I;16B at 65535, else PpmDecoder's ``min(65535,
    round(v / maxval * 65535))``). ``convert("RGBA")`` clips that at 255;
    the port keeps its high byte, as for 16-bit grey PNG, TIFF and IM."""
    rng = np.random.default_rng(7)
    w, h = 9, 4
    if case == "pil-I":
        data = pil_file(pil_image("I", w, h, seed=8), "PPM")
        maxval = 65535
    elif case == "pil-I;16":
        data = pil_file(Image.frombytes("I;16", (w, h), rng.integers(
            0, 65536, (h, w)).astype("<u2").tobytes()), "PPM")
        maxval = 65535
    else:
        maxval = int(case[7:])
        samples = rng.integers(0, 65536, (h, w)) % (maxval + 2)
        data = pnm(b"P5", w, h, maxval, samples.astype(">u2").tobytes())
    assert data.split(b"\n")[2] == b"%d" % maxval
    samples = np.frombuffer(data[-2 * w * h:], ">u2").reshape(h, w)
    scaled = np.array([[min(65535, round(int(v) / maxval * 65535))
                        for v in row] for row in samples])
    path = tmp_path / "x.pgm"
    path.write_bytes(data)
    got = image.load_rgba8(str(path))
    want = np.full((h, w, 4), 255, np.uint8)
    want[..., :3] = (scaled >> 8)[..., None]
    np.testing.assert_array_equal(got, want)
    pil = (jimage.load_rgba(str(path)) * 255).round().astype(np.uint8)
    np.testing.assert_array_equal(pil[..., 0], np.minimum(scaled, 255))
    assert (scaled > 255).any()


def _pnm_damage():
    body = bytes(range(200)) * 4
    cases = {
        "P4-short": pnm(b"P4", 9, 3, None, bytes(5)),
        "P5-255-short": pnm(b"P5", 5, 3, 255, bytes(14)),
        "P5-65535-short": pnm(b"P5", 5, 3, 65535, bytes(29)),
        "P5-300-short": pnm(b"P5", 5, 3, 300, bytes(29)),
        "P6-1000-short": pnm(b"P6", 5, 3, 1000, bytes(89)),
        "P6-100-short": pnm(b"P6", 5, 3, 100, bytes(44)),
        "Pf-short": pnm(b"Pf", 5, 3, b"-1.0", bytes(59)),
        "bad-width": b"P5\n5x 3\n255\n" + body,
        "bad-maxval": b"P6\n5 3\n25a\n" + body,
        "long-token": b"P5\n123456789012 1\n255\n" + body,
        "no-tokens": b"P6\n",
        "width-0": pnm(b"P5", 0, 3, 255, body),
        "height-negative": pnm(b"P6", 4, -2, 255, body),
        "maxval-0": pnm(b"P5", 5, 3, 0, body),
        "maxval-65536": pnm(b"P6", 5, 3, 65536, body),
        "maxval-negative": pnm(b"P5", 5, 3, -1, body),
    }
    for scale in (b"0", b"-0.0", b"inf", b"-inf", b"nan", b"1e400",
                  b"0x10", b"one"):
        cases[f"Pf-scale-{scale.decode()}"] = pnm(b"Pf", 5, 3, scale, body)
    return cases


@pytest.mark.parametrize("case", sorted(_pnm_damage()))
def test_damaged_pnm_is_none_as_in_jax(case, tmp_path):
    """Truncated pixels (PIL's raw decoder: "image file is truncated";
    PpmDecoder: "not enough image data"), a bad header token, a Pf scale
    of zero or not finite, a maxval of 0 or 65536 or above."""
    none_in_both(tmp_path, "x.ppm", _pnm_damage()[case])


# ---- TGA -------------------------------------------------------------------

def tga1(w: int, h: int, kind: int = 3, flags: int = 0, image_id=b"",
         body: bytes = None, cmap: int = 0, seed: int = 0) -> bytes:
    """A TGA at depth 1 (rows of ``(w + 7) // 8`` bytes, random unless
    ``body``), with a ``cmap``-bit colour map of two entries if set."""
    if body is None:
        body = np.random.default_rng(seed).integers(
            0, 256, h * ((w + 7) // 8), np.uint8).tobytes()
    head = struct.pack("<BBBHHBHHHHBB", len(image_id), bool(cmap), kind, 0,
                       2 if cmap else 0, cmap, 0, 0, w, h, 1, flags)
    return head + image_id + bytes(2 * cmap // 8) + body


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
def test_pil_written_1bit_tga_decodes_as_jax(size, tmp_path):
    data = pil_file(pil_image("1", *size, seed=4), "TGA")
    assert data[2] == 3 and data[16] == 1
    held(tmp_path, "x.tga", data)


@pytest.mark.parametrize("w", [1, 8, 10, 17])
@pytest.mark.parametrize("flags", [0, 0x10, 0x20, 0x30, 0x2F])
def test_1bit_tga_decodes_as_jax(flags, w, tmp_path):
    """Image type 3 at depth 1: rows padded to a byte, each origin (the
    flags' other bits ignored), an image id before the pixels."""
    held(tmp_path, "x.tga", tga1(w, 3, flags=flags, image_id=b"id!",
                                 seed=w + flags))


def _rle1_cases():
    cases = {f"pil-{w}x{h}": pil_file(pil_image("1", w, h, seed=5), "TGA",
                                     rle=True) for w, h in SIZES}
    cases.update({
        "runs": tga1(16, 3, kind=11, body=bytes([0x85, 0xAA]) * 4),
        "literals": tga1(16, 3, kind=11, body=bytes([0x05]) + bytes(range(6))),
        "long": tga1(9, 2, kind=11, body=bytes([0x81, 0x0F]) * 300),
        "empty": tga1(9, 2, kind=11, body=b""),
    })
    return cases


@pytest.mark.parametrize("case", sorted(_rle1_cases()))
def test_rle_1bit_tga_is_none_as_in_jax(case, tmp_path):
    """Image type 11 at depth 1, PIL's own file and hand-built ones: PIL's
    TgaRleDecode takes ``depth // 8``, 0 bytes, a pixel, so no packet
    fills a row and every file is "truncated"; the port raised
    NotImplementedError here."""
    none_in_both(tmp_path, "x.tga", _rle1_cases()[case])


def _tga_damage():
    return {
        "short": tga1(10, 3)[:-1],
        **{f"type{kind}-depth1": tga1(10, 3, kind=kind)
           for kind in (1, 2, 9, 10)},
        **{f"map{bits}": tga1(10, 3, cmap=bits) for bits in (16, 24, 32)},
        "rle-map": tga1(10, 3, kind=11, cmap=24),
        "type1-depth16": tga1(10, 3, kind=1)[:16] + b"\x10\0" + bytes(60),
        "type3-depth24": tga1(10, 3, kind=3)[:16] + b"\x18\0" + bytes(90),
    }


@pytest.mark.parametrize("case", sorted(_tga_damage()))
def test_damaged_1bit_tga_is_none_as_in_jax(case, tmp_path):
    """Cut pixels, depth 1 in image types PIL has no raw mode for, a
    colour map on mode 1 (PIL cannot put a palette on it), and depths
    PIL's table lacks for grey and colour-mapped images."""
    none_in_both(tmp_path, "x.tga", _tga_damage()[case])


# ---- TIFF ------------------------------------------------------------------

PIL_COMPRESSIONS = [None, "tiff_lzw", "tiff_adobe_deflate", "packbits"]


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
@pytest.mark.parametrize("compression", PIL_COMPRESSIONS,
                         ids=lambda c: c or "raw")
@pytest.mark.parametrize("mode", ["CMYK", "I", "YCbCr"])
def test_pil_written_tiff_decodes_as_jax(mode, compression, size, tmp_path):
    """PIL's CMYK, mode I (32-bit signed) and YCbCr TIFFs in each
    compression; the uncompressed YCbCr one is None in both (the repair
    below)."""
    save = {} if compression is None else {"compression": compression}
    data = pil_file(pil_image(mode, *size, seed=6), "TIFF", **save)
    if mode == "YCbCr" and compression is None:
        none_in_both(tmp_path, "x.tif", data)
    else:
        held(tmp_path, "x.tif", data)


ORDERS = {"II": "<", "MM": ">"}
COMPRESSIONS = {"raw": 1, "lzw": 5, "deflate": 8, "packbits": 32773}


def _tiff_cases():
    rng = np.random.default_rng(9)
    w, h = 13, 7
    cases = {}
    cmyk = rng.integers(0, 256, (h, w, 6))
    cmyk[:, :5] = cmyk[:, :1]                  # runs for PackBits
    wide = rng.integers(0, 65536, (h, w, 4))
    i32 = rng.integers(-2 ** 31, 2 ** 31, (h, w, 1))
    i32[:, :6] = rng.integers(-300, 600, (h, 6, 1))
    i16 = rng.integers(-2 ** 15, 2 ** 15, (h, w, 1))
    i16[:, :6] = rng.integers(-300, 600, (h, 6, 1))
    ycc = rng.integers(0, 256, (h, w, 3))
    ycc[:, :4] = ycc[:, :1]
    sub = (530, 3, [1, 1])
    for o, order in ORDERS.items():
        for c, comp in COMPRESSIONS.items():
            t = lambda *a, **k: ti.tiff_bytes(  # noqa: E731
                *a, order=order, compression=comp, **k)
            cases[f"cmyk-{o}-{c}"] = t(cmyk[..., :4], photometric=5)
            cases[f"cmykx-{o}-{c}"] = t(cmyk[..., :5], photometric=5,
                                        extra=[0])
            cases[f"cmykxx-{o}-{c}"] = t(cmyk, photometric=5, extra=[0, 0])
            cases[f"cmyk16-{o}-{c}"] = t(wide, 16, photometric=5)
            cases[f"cmyk-planar-{o}-{c}"] = t(cmyk[..., :4], photometric=5,
                                              planar=2)
            cases[f"i32s-{o}-{c}"] = t(i32 & 0xFFFFFFFF, 32, sample_format=2)
            cases[f"i16s-{o}-{c}"] = t(i16 & 0xFFFF, 16, sample_format=2)
            cases[f"f32-{o}-{c}"] = t((i16 / 7.0).astype(np.float32), 32,
                                      sample_format=3)
            if order == "<":                  # I;32N: little-endian only
                cases[f"i32n-{o}-{c}"] = t(i32 & 0xFFFFFFFF, 32,
                                           sample_format=1)
            if comp != 1:
                cases[f"ycbcr-{o}-{c}"] = t(ycc, photometric=6,
                                            extra_tags=(sub,))
                cases[f"ycbcr-strips-{o}-{c}"] = t(
                    ycc, photometric=6, rows_per_strip=3, extra_tags=(sub,))
        t = lambda *a, **k: ti.tiff_bytes(*a, order=order, **k)  # noqa
        cases[f"ycbcr-planar-{o}"] = t(ycc, photometric=6, compression=5,
                                       planar=2, extra_tags=(sub,))
        cases[f"ycbcr-tiles-{o}"] = t(ycc, photometric=6, compression=8,
                                      tile=(16, 16), extra_tags=(sub,))
        cases[f"ycbcr-predictor-{o}"] = t(ycc, photometric=6,
                                          compression=5, predictor=2,
                                          extra_tags=(sub,))
        cases[f"cmyk-predictor-{o}"] = t(cmyk[..., :4], photometric=5,
                                         compression=8, predictor=2)
        cases[f"cmyk-tiles-{o}"] = t(cmyk[..., :4], photometric=5,
                                     compression=32773, tile=(16, 16))
        cases[f"i16s-predictor-{o}"] = t(i16 & 0xFFFF, 16, sample_format=2,
                                         compression=5, predictor=2)
        # uncompressed YCbCr in separate planes: PIL's raw R, G, B planes
        cases[f"ycbcr-raw-planar-{o}"] = t(ycc, photometric=6, planar=2)
        cases[f"ycbcr-raw-grey-{o}"] = t(ycc[..., :1], photometric=6)
    rat = lambda *v: (532, 5, [x for p in v for x in p])  # noqa: E731
    for name, tag in (
            ("ref-studio", rat((16, 1), (235, 1), (128, 1), (240, 1),
                               (128, 1), (240, 1))),
            ("ref-odd", rat((5, 2), (601, 3), (100, 1), (200, 0),
                            (150, 1), (300, 7))),
            ("ref-short", (532, 3, [16, 235, 128, 240, 128, 240])),
            ("ref-count-3", rat((16, 1), (235, 1), (128, 1))),
            ("luma-709", (529, 5, [2126, 10000, 7152, 10000, 722, 10000])),
            ("luma-long", (529, 4, [1, 2, 1]))):
        cases[f"ycbcr-{name}"] = ti.tiff_bytes(ycc, photometric=6,
                                               compression=5,
                                               extra_tags=(sub, tag))
    return cases


TIFF_CASES = _tiff_cases()


@pytest.mark.parametrize("case", sorted(TIFF_CASES))
def test_tiff_decodes_as_jax(case, tmp_path):
    """CMYK at 8 bits with 0, 1 or 2 extra samples and at 16 (the high
    byte), PIL's ``cmyk2rgb``; mode I (32-bit signed, 32-bit unsigned
    little-endian, 16-bit signed) clipped to 0..255, a compressed
    big-endian one (and a float) read with its bytes swapped as PIL reads
    libtiff's native samples; compressed YCbCr through libtiff's tables
    in strips, tiles and planes, under ReferenceBlackWhite and
    YCbCrCoefficients as the file gives them (a count libtiff ignores
    giving its default); uncompressed YCbCr in planes or one sample, read
    raw as PIL reads it; in both byte orders and four compressions."""
    held(tmp_path, "x.tif", TIFF_CASES[case])


@pytest.mark.parametrize("size", SIZES, ids=SIZE_IDS)
def test_uncompressed_ycbcr_tiff_is_none_as_in_jax(size, tmp_path):
    """PIL reads an uncompressed YCbCr TIFF raw as ``RGBX``, 4 bytes a
    pixel: past the end of the strip PIL writes after the IFD, so the JAX
    package gets None; the port raised NotImplementedError here."""
    data = pil_file(pil_image("YCbCr", *size, seed=10), "TIFF")
    none_in_both(tmp_path, "x.tif", data)


@pytest.mark.parametrize("rows_per_strip", [None, 2])
def test_uncompressed_ycbcr_tiff_reads_four_bytes_a_pixel(rows_per_strip,
                                                          tmp_path):
    """With bytes enough after each strip, PIL's raw ``RGBX`` reading: the
    first three of each 4 bytes as RGB, no colour conversion."""
    rng = np.random.default_rng(11)
    w, h = 7, 5
    quads = rng.integers(0, 256, (h, w, 4), np.uint8)
    rps = rows_per_strip or h
    # the strips hold 4 bytes a pixel; the header says 3 samples
    strips = [quads[y:y + rps].tobytes() for y in range(0, h, rps)]
    body = ti.tiff_bytes(quads[..., :3], photometric=6,
                         rows_per_strip=rows_per_strip)
    head_len = len(body) - quads[..., :3].size
    offsets, at = [], head_len
    for s in strips:
        offsets.append(at)
        at += len(s)
    data = bytearray(body[:head_len] + b"".join(strips))
    order = "<"
    n = struct.unpack_from(order + "H", data, 8)[0]
    for i in range(n):
        tag, kind, count, value = struct.unpack_from(order + "HHII", data,
                                                     10 + 12 * i)
        if tag == 273:
            pos = 10 + 12 * i + 8 if count == 1 else value
            struct.pack_into(order + f"{count}I", data, pos, *offsets)
    got = held(tmp_path, "x.tif", bytes(data))
    np.testing.assert_array_equal(got[..., :3], quads[..., :3])


YCC_LEVELS = [0, 16, 128, 235, 255]


@pytest.mark.parametrize("y", YCC_LEVELS)
@pytest.mark.parametrize("ref", ["default", "studio"])
def test_ycbcr_tiff_holds_libtiffs_conversion_for_every_cb_cr(ref, y,
                                                              tmp_path):
    """libtiff 4.7.1's ``TIFFYCbCrToRGBInit`` tables and
    ``TIFFYCbCrtoRGB``'s clamp, which PIL's reader of compressed YCbCr
    goes through, over all 65,536 (Cb, Cr) pairs at one Y level: a
    256x256 PackBits file, with the default ReferenceBlackWhite and with
    (16, 235, 128, 240, 128, 240)."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256))
    ycc = np.stack([np.full_like(cb, y), cb, cr], -1)
    tags = [(530, 3, [1, 1])]
    if ref == "studio":
        tags.append((532, 5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240,
                              1]))
    held(tmp_path, "x.tif", ti.tiff_bytes(ycc, photometric=6,
                                          compression=32773,
                                          extra_tags=tags))


def test_compressed_ycbcr_with_one_sample_is_none_as_in_jax(tmp_path):
    """libtiff's directory reading refuses one-sample YCbCr data."""
    ycc = np.random.default_rng(12).integers(0, 256, (5, 7, 1))
    none_in_both(tmp_path, "x.tif", ti.tiff_bytes(
        ycc, photometric=6, compression=5, extra_tags=((530, 3, [1, 1]),)))


def _tiff_damage():
    rng = np.random.default_rng(13)
    x = rng.integers(0, 256, (6, 9, 4))
    sub = ((530, 3, [1, 1]),)
    cases = {}
    for name, data in (
            ("cmyk-raw", ti.tiff_bytes(x, photometric=5)),
            ("cmyk-lzw", ti.tiff_bytes(x, photometric=5, compression=5)),
            ("i32-raw", ti.tiff_bytes(x[..., :1], 32, sample_format=2)),
            ("i32-deflate", ti.tiff_bytes(x[..., :1], 32, sample_format=2,
                                          compression=8)),
            ("ycbcr-lzw", ti.tiff_bytes(x[..., :3], photometric=6,
                                        compression=5, extra_tags=sub)),
            ("ycbcr-packbits-strips", ti.tiff_bytes(
                x[..., :3], photometric=6, compression=32773,
                rows_per_strip=2, extra_tags=sub))):
        for cut in (1, 7):
            cases[f"{name}-cut{cut}"] = data[:-cut]
    luma0 = (529, 5, [299, 1000, 0, 1, 114, 1000])
    cases["ycbcr-zero-green"] = ti.tiff_bytes(
        x[..., :3], photometric=6, compression=5, extra_tags=sub + (luma0,))
    cases["ycbcr-ref-too-large"] = ti.tiff_bytes(
        x[..., :3], photometric=6, compression=5, extra_tags=sub + (
            (532, 5, [0, 1, 4000000000, 1, 128, 1, 255, 1, 128, 1, 255,
                      1]),))
    return cases


@pytest.mark.parametrize("case", sorted(_tiff_damage()))
def test_damaged_tiff_is_none_as_in_jax(case, tmp_path):
    """Strips cut short (raw and compressed), YCbCrCoefficients with a
    zero green and a ReferenceBlackWhite value out of libtiff's range
    (``initYCbCrConversion``'s checks)."""
    none_in_both(tmp_path, "x.tif", _tiff_damage()[case])


def _tiff_refused():
    ycc = np.random.default_rng(14).integers(0, 256, (8, 8, 3))
    t = lambda **k: ti.tiff_bytes(ycc, photometric=6, **k)  # noqa: E731
    return {
        "subsampling 2x2": (t(compression=5, extra_tags=(
            (530, 3, [2, 2]),)), r"subsampling \(2, 2\)"),
        "no subsampling tag": (t(compression=8), r"subsampling \(2, 2\)"),
        "subsampling 2x1": (t(compression=32773, extra_tags=(
            (530, 3, [2, 1]),)), r"subsampling \(2, 1\)"),
        "orientation 3": (t(compression=5, extra_tags=(
            (530, 3, [1, 1]), (274, 3, [3]))), "orientation 3"),
        "raw tiles": (t(tile=(16, 16)), "YCbCr tiles"),
        "float ReferenceBlackWhite": (retyped(t(compression=5, extra_tags=(
            (530, 3, [1, 1]), (532, 5, [1] * 12))), 532, 11), "tag 532"),
    }


def retyped(data: bytes, tag: int, kind: int) -> bytes:
    """A little-endian TIFF with the type of ``tag``'s entry set to
    ``kind`` (its count and value offset kept)."""
    out = bytearray(data)
    for i in range(struct.unpack_from("<H", out, 8)[0]):
        if struct.unpack_from("<H", out, 10 + 12 * i)[0] == tag:
            struct.pack_into("<H", out, 12 + 12 * i, kind)
    return bytes(out)


@pytest.mark.parametrize("case", sorted(_tiff_refused()))
def test_ycbcr_flavours_not_decoded_raise_naming_the_file(case, tmp_path):
    """Subsampled YCbCr (a missing tag is libtiff's default, 2x2), an
    orientation libtiff's RGBA reader would turn the image by,
    uncompressed YCbCr tiles, and a ReferenceBlackWhite of another type
    than RATIONAL or integer."""
    data, what = _tiff_refused()[case]
    refused(tmp_path, data, what)


# ---- scenes ----------------------------------------------------------------

def cmyk_and_ycbcr(tmp_path):
    """Paths of a 61x47 uncompressed CMYK TIFF and a 31x23 PackBits YCbCr
    TIFF at subsampling (1, 1), from the fixture tool's encoder."""
    rough = tmp_path / "rough.tif"
    rough.write_bytes(fx.tiff_map_bytes(fx.cmyk_of(ti.smooth_rgb(18, 61, 47)),
                                        5))
    normal = tmp_path / "normal.tif"
    normal.write_bytes(fx.tiff_map_bytes(
        fx.ycbcr_of(ti.smooth_rgb(19, 31, 23)), 6, packbits=True,
        rows_per_strip=5))
    return str(rough), str(normal)


def test_map_encoders_write_what_pil_reads(tmp_path):
    """The fixture tool's TIFF, PackBits, CMYK and YCbCr encoders (which
    make the card's reader maps): PIL reads both files, and the port's
    decodes equal PIL's."""
    for path in cmyk_and_ycbcr(tmp_path):
        with open(path, "rb") as f:
            held(tmp_path, "x.tif", f.read())


@pytest.mark.parametrize("build_bvh", [False, True])
def test_compile_with_cmyk_and_ycbcr_maps_equals_jax(build_bvh, tmp_path):
    rough, normal = cmyk_and_ycbcr(tmp_path)
    jsc = cornell_scene(depth=2, res=(16, 16),
                        block_types=(MaterialType.GLOSSY, MaterialType.GLOSSY))
    jsc.set_roughness_texture(0, 6, rough)
    jsc.set_roughness_texture(0, 7, rough)
    jsc.set_normal_texture(0, 3, normal)
    got = to_port_scene(jsc).compile("cpu", build_bvh=build_bvh)
    assert got.textures.shape == (2, 47, 61, 4)
    assert_fields_equal(jsc.compile(build_bvh=build_bvh), got)


@pytest.mark.parametrize("dispersion", [False, "hero"])
def test_cmyk_and_ycbcr_mapped_trace_matches_jax_under_one_key(dispersion,
                                                               tmp_path):
    """The glossy wall of ``normal_mapped_wall`` with the CMYK TIFF
    roughness map and the YCbCr TIFF normal map (rtol 1e-4 / atol
    1e-6)."""
    rough, normal = cmyk_and_ycbcr(tmp_path)
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    got, want = trace_both(jsc, jsc.trace_depth, 3, dispersion)
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
tmp, assets = sys.argv[2], os.path.join(sys.argv[1], "assets")
rough, normal = os.path.join(tmp, "r.tif"), os.path.join(tmp, "n.tif")
px = fx.procedural_rgb(40, 24, 3)
with open(rough, "wb") as f:
    f.write(fx.tiff_map_bytes(fx.cmyk_of(px), 5))
with open(normal, "wb") as f:
    f.write(fx.tiff_map_bytes(fx.ycbcr_of(px[::-1]), 6, packbits=True))
data_dir = os.path.join(sys.argv[1], "tests", "torch_data")
for name in ("small.pbm", "grey16.pgm", "small_1000.ppm", "small.pfm",
             "small_1bit.tga", "small_i32_lzw.tif"):
    assert image.load_rgba8(os.path.join(data_dir, name)).shape == (29, 37, 4)
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
assert tuple(data.textures.shape) == (2, 24, 40, 4), data.textures.shape
img = pt.RenderSession(sc, "cpu", seed=1).run(2, batch=2)
assert img.shape == (8, 12, 4) and np.isfinite(img).all() and img.mean() > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "PIL"))
assert not bad, bad
print("ok")
"""


def test_cmyk_and_ycbcr_mapped_render_imports_neither_jax_nor_pil(tmp_path):
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_TIFF, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")

