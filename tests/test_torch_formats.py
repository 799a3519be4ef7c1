"""The port's texture formats against the JAX package's ``load_rgba``
(PIL 12 on libjpeg-turbo): JPEG through the host library's decoder
(baseline, extended, progressive; grey, YCbCr and RGB; 4:4:4, 4:2:2,
4:4:0, 4:2:0 and other factors; restart intervals, odd sizes, scan data
cut short), PNG at 16 bits and Adam7-interlaced at every bit depth, BMP,
TGA and binary PNM, the decoder chosen by the file's leading bytes. Every
case is held bit for bit (tolerance 0) except the one named deviation, a
16-bit grey PNG, held to its high byte. Then the flavours still refused,
the committed fixtures' digests, ``Scene.compile`` with a JPEG roughness
map and a BMP normal map field by field, and a 16x16 trace of that scene
under one key (rtol 1e-4 / atol 1e-6, as ``tests/test_torch_spectral.py``
states it).
"""

import hashlib
import json
import os
import struct

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
from test_torch_scene import assert_fields_equal, to_port_scene  # noqa: E402,E501
from test_torch_spectral import assert_same, trace_both  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_data")


def held(tmp_path, name: str, data: bytes):
    """The port's decode of ``data`` (written as ``name``), held bitwise to
    the JAX package's; returns it."""
    path = tmp_path / name
    path.write_bytes(data)
    got, want = image.load_rgba(str(path)), jimage.load_rgba(str(path))
    assert want is not None, "PIL does not read this case"
    assert got is not None and got.dtype == np.float32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    return got


# ---- JPEG -----------------------------------------------------------------

SIZES = [(1, 1), (2, 3), (5, 7), (17, 9), (33, 31), (64, 48)]
CODINGS = {"baseline": {}, "optimized": {"optimize": True},
           "progressive": {"progressive": True}}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("subsampling", [0, 1, 2],
                         ids=["444", "422", "420"])
@pytest.mark.parametrize("coding", list(CODINGS))
def test_jpeg_colour_decodes_as_jax(coding, subsampling, size, tmp_path):
    w, h = size
    data = ti.jpeg_bytes(ti.smooth_rgb(w * h, w, h), quality=85,
                         subsampling=subsampling, **CODINGS[coding])
    held(tmp_path, "tex.jpg", data)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("coding", ["baseline", "progressive"])
def test_jpeg_grey_decodes_as_jax(coding, size, tmp_path):
    w, h = size
    data = ti.jpeg_bytes(ti.smooth_rgb(w + h, w, h), "L", quality=75,
                         **CODINGS[coding])
    held(tmp_path, "grey.jpg", data)


def _noise(w, h, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _jpeg_flavours():
    """name -> JPEG bytes of each flavour PIL reads and the decoder takes;
    the ones PIL does not write are its files rewritten (the entropy data
    decodes the same, into another image)."""
    x16 = ti.smooth_rgb(5, 48, 32)                 # whole 16x16 MCUs
    b422 = ti.jpeg_bytes(x16, quality=90, subsampling=1)
    p422 = ti.jpeg_bytes(x16, quality=90, subsampling=1, progressive=True)
    b420 = ti.jpeg_bytes(x16, quality=90, subsampling=2)
    p420 = ti.jpeg_bytes(x16, quality=90, subsampling=2, progressive=True)
    rgb = ti.jpeg_bytes(x16, quality=90, keep_rgb=True, subsampling=0)
    prgb = ti.jpeg_bytes(x16, quality=90, keep_rgb=True, subsampling=0,
                         progressive=True)
    odd = ti.smooth_rgb(6, 45, 27)
    return {
        # Y 2x1 -> 1x2 with the frame 24x64: 4:4:0, h1v2 fancy upsampling
        "440-baseline": ti.patch_frame(b422, 24, 64, [0x12, 0x11, 0x11]),
        "440-progressive": ti.patch_frame(p422, 24, 64, [0x12, 0x11, 0x11]),
        "440-odd-size": ti.patch_frame(b422, 21, 59, [0x12, 0x11, 0x11]),
        # Y 2x2 -> 4x1 and 1x4: box upsampling (libjpeg's int_upsample)
        "411": ti.patch_frame(b420, 96, 16, [0x41, 0x11, 0x11]),
        "1x4": ti.patch_frame(p420, 24, 64, [0x14, 0x11, 0x11]),
        "grey-2x2-factor": ti.patch_frame(
            ti.jpeg_bytes(x16, "L", quality=80), factors=[0x22]),
        "sof1": ti.patch_frame(b420, kind=0xC1),
        "adobe-rgb": rgb,
        "adobe-rgb-progressive": prgb,
        "rgb-by-component-ids": ti.drop_segment(rgb, 0xEE),
        "ids-1-2-3-without-markers": ti.patch_frame(
            ti.drop_segment(rgb, 0xEE), ids=[1, 2, 3]),
        "ycbcr-without-jfif": ti.drop_segment(b420, 0xE0),
        "restart-blocks": ti.jpeg_bytes(odd, quality=70,
                                        restart_marker_blocks=3),
        "restart-rows-progressive": ti.jpeg_bytes(
            odd, quality=70, progressive=True, restart_marker_rows=1),
        "restart-420-optimized": ti.jpeg_bytes(
            odd, quality=95, subsampling=2, optimize=True,
            restart_marker_blocks=1),
        "noise-q98": ti.jpeg_bytes(_noise(45, 27), quality=98),
        "noise-q20-progressive": ti.jpeg_bytes(_noise(45, 27, 1), quality=20,
                                               progressive=True),
        # the last scan runs into EOI: zero bits, then the segment's rest
        # left as it is (libjpeg's insufficient data)
        "scan-cut-short": ti.cut_scan_data(ti.jpeg_bytes(_noise(45, 27, 2),
                                                         quality=90)),
        "scan-cut-short-restarts": ti.cut_scan_data(ti.jpeg_bytes(
            _noise(45, 27, 3), quality=90, restart_marker_blocks=2), 0.3),
    }


@pytest.mark.parametrize("flavour", list(_jpeg_flavours()))
def test_jpeg_flavour_decodes_as_jax(flavour, tmp_path):
    held(tmp_path, "tex.jpg", _jpeg_flavours()[flavour])


# ---- PNG: 16 bits and Adam7 ----------------------------------------------

PNG_SIZES = [(1, 1), (2, 3), (3, 1), (5, 7), (9, 13), (17, 4)]
PNG_FLAVOURS = [(c, d) for c, depths in ((0, (1, 2, 4, 8)), (2, (8, 16)),
                                         (3, (1, 2, 4, 8)), (4, (8, 16)),
                                         (6, (8, 16)))
                for d in depths]


@pytest.mark.parametrize("size", PNG_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("colour,depth", PNG_FLAVOURS,
                         ids=[f"type{c}-{d}bit" for c, d in PNG_FLAVOURS])
def test_adam7_png_decodes_as_jax(colour, depth, size, tmp_path):
    """Adam7 at every bit depth, images under 8 pixels wide or high (whose
    empty passes carry no filter bytes) included."""
    w, h = size
    held(tmp_path, "i.png", ti.random_png(w * 31 + h, w, h, colour, depth,
                                          interlace=1))


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("colour", [2, 4, 6])
def test_16bit_png_keeps_the_high_byte_as_jax(colour, interlace, tmp_path):
    got = held(tmp_path, "deep.png", ti.random_png(colour, 11, 6, colour, 16,
                                                   interlace))
    assert got.shape == (6, 11, 4)


@pytest.mark.parametrize("key", ["high-bytes", "16-bit"])
def test_16bit_rgb_transparency_as_jax(key, tmp_path):
    """PIL compares the 16-bit tRNS key with the 8-bit high bytes: a key
    at or under 255 marks the pixels whose high bytes equal it, a larger
    one none."""
    rng = np.random.default_rng(4)
    s = rng.integers(0, 1 << 16, (5, 6, 3))
    s[1, :3] = s[0, 0]
    k = s[0, 0] >> 8 if key == "high-bytes" else s[0, 0]
    got = held(tmp_path, "t.png", ti.png_bytes(
        s, 2, 16, trns=struct.pack(">HHH", *(int(v) for v in k))))
    assert (got[..., 3] == 0).any() == (key == "high-bytes")


def test_16bit_grey_png_is_the_named_deviation(tmp_path):
    """The one deviation from PIL: a 16-bit grey PNG keeps each sample's
    high byte (as stb_image, the reference's loader, and PIL's own 16-bit
    RGB path do), where PIL opens mode I;16 and ``convert("RGBA")`` clips
    at 255. Its tRNS key is compared with the 16-bit sample."""
    samples = np.array([[0, 250, 500, 750, 55745, 65535]])[..., None]
    path = tmp_path / "grey16.png"
    path.write_bytes(ti.png_bytes(samples, 0, 16))
    got = image.load_rgba8(str(path))
    np.testing.assert_array_equal(got[0, :, 0], [0, 0, 1, 2, 217, 255])
    assert (got[..., 1:3] == got[..., :1]).all() and (got[..., 3] == 255).all()
    pil = np.round(jimage.load_rgba(str(path)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(pil[0, :, 0], [0, 250, 255, 255, 255, 255])
    path.write_bytes(ti.png_bytes(samples, 0, 16, interlace=1,
                                  trns=struct.pack(">H", 500)))
    got = image.load_rgba8(str(path))
    np.testing.assert_array_equal(got[0, :, 3], [255, 255, 0, 255, 255, 255])


# ---- BMP, TGA, PNM --------------------------------------------------------

def _bmp_cases():
    rng = np.random.default_rng(7)
    w, h = 7, 5
    rgb = rng.integers(0, 256, (h, w, 3), np.uint8)
    quad = rng.integers(0, 256, (h, w, 4), np.uint8)
    p16 = rng.integers(0, 1 << 16, (h, w)).astype("<u2")
    cases = {}
    for top in (False, True):
        o = "top-down" if top else "bottom-up"
        for header in (40, 108, 124):
            cases[f"24-{header}-{o}"] = ti.bmp_bytes(
                w, h, 24, [r[:, ::-1].tobytes() for r in rgb], header=header,
                top_down=top)
            cases[f"32-bi-rgb-{header}-{o}"] = ti.bmp_bytes(
                w, h, 32, [r.tobytes() for r in quad], header=header,
                top_down=top)
        cases[f"16-bi-rgb-{o}"] = ti.bmp_bytes(
            w, h, 16, [r.tobytes() for r in p16], top_down=top)
        for masks in ((0xF800, 0x7E0, 0x1F, 0), (0x7C00, 0x3E0, 0x1F, 0)):
            cases[f"16-bitfields-{masks[0]:x}-{o}"] = ti.bmp_bytes(
                w, h, 16, [r.tobytes() for r in p16], compression=3,
                masks=masks, top_down=top)
        for masks in ((0xFF0000, 0xFF00, 0xFF, 0),
                      (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                      (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                      (0xFF0000, 0xFF00, 0xFF, 0xFF000000)):
            for header in (40, 124):
                cases[f"32-bitfields-{masks[3]:x}-{header}-{o}"] = \
                    ti.bmp_bytes(w, h, 32, [r.tobytes() for r in quad],
                                 header=header, compression=3, masks=masks,
                                 top_down=top)
    for bits in (1, 4, 8):
        for header in (12, 40):
            for colors in (0, 3):
                n = colors or 1 << bits
                pad = 3 if header == 12 else 4
                pal = rng.integers(0, 256, n * pad, np.uint8).tobytes()
                idx = rng.integers(0, 1 << bits, (h, w)).astype(np.uint8)
                rows = [np.packbits(np.unpackbits(r[:, None], axis=1)[
                    :, 8 - bits:].reshape(-1)).tobytes() for r in idx]
                cases[f"{bits}-palette-{header}-{colors or 'full'}"] = \
                    ti.bmp_bytes(w, h, bits, rows, palette=pal,
                                 header=header,
                                 colors=colors if header != 12 else 0)
    grey = bytes(v for i in range(256) for v in (i, i, i, 0))
    cases["8-grey-palette"] = ti.bmp_bytes(
        w, h, 8, [r[:, 0].tobytes() for r in rgb], palette=grey)
    for mode in ("1", "L", "P", "RGB"):
        img = Image.fromarray(rgb)
        img = img.quantize(12) if mode == "P" else img.convert(mode)
        out = __import__("io").BytesIO()
        img.save(out, "BMP")
        cases[f"pil-{mode}"] = out.getvalue()
    return cases


@pytest.mark.parametrize("case", list(_bmp_cases()))
def test_bmp_decodes_as_jax(case, tmp_path):
    held(tmp_path, "tex.bmp", _bmp_cases()[case])


def _tga_cases():
    rng = np.random.default_rng(8)
    w, h = 9, 5
    cases = {}
    for flags in (0, 0x20, 0x10, 0x30):
        for depth in (24, 32):
            px = rng.integers(0, 256, (h, w, depth // 8), np.uint8)
            px[:, :4] = px[:, :1]               # runs, some across rows
            cases[f"type2-{depth}-{flags:x}"] = ti.tga_bytes(
                w, h, 2, depth, px.tobytes(), flags=flags, image_id=b"id")
            cases[f"type10-{depth}-{flags:x}"] = ti.tga_bytes(
                w, h, 10, depth, px.tobytes(), flags=flags)
        grey = rng.integers(0, 256, (h, w), np.uint8)
        grey[:, :5] = 7
        for kind in (3, 11):
            cases[f"type{kind}-{flags:x}"] = ti.tga_bytes(
                w, h, kind, 8, grey.tobytes(), flags=flags)
        for start, size in ((0, 256), (5, 40)):
            cmap = rng.integers(0, 256, 3 * size, np.uint8).tobytes()
            for kind in (1, 9):
                cases[f"type{kind}-map{start}+{size}-{flags:x}"] = \
                    ti.tga_bytes(w, h, kind, 8, grey.tobytes(), cmap=cmap,
                                 cmap_start=start, flags=flags)
    la = rng.integers(0, 256, (h, w, 2), np.uint8)
    cases["type3-grey-alpha"] = ti.tga_bytes(w, h, 3, 16, la.tobytes())
    return cases


@pytest.mark.parametrize("case", list(_tga_cases()))
def test_tga_decodes_as_jax(case, tmp_path):
    held(tmp_path, "tex.tga", _tga_cases()[case])


@pytest.mark.parametrize("kind", [1, 9])
def test_tga_with_a_32bit_colour_map_is_none_as_in_jax(kind, tmp_path):
    """PIL reads the header but refuses to load a 32-bit colour map
    ("unrecognized raw mode"), so the JAX package binds nothing; the port
    follows it."""
    rng = np.random.default_rng(kind)
    path = tmp_path / "map32.tga"
    path.write_bytes(ti.tga_bytes(
        4, 3, kind, 8, rng.integers(0, 16, 12, np.uint8).tobytes(),
        cmap=rng.integers(0, 256, 64, np.uint8).tobytes(), map_depth=32))
    assert jimage.load_rgba(str(path)) is None
    assert image.load_rgba(str(path)) is None


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
@pytest.mark.parametrize("rle", [False, True])
def test_pil_written_tga_decodes_as_jax(mode, rle, tmp_path):
    img = Image.fromarray(ti.smooth_rgb(3, 13, 9))
    img = img.quantize(20) if mode == "P" else img.convert(mode)
    path = tmp_path / "pil.tga"
    img.save(path, compression="tga_rle" if rle else None)
    held(tmp_path, "pil.tga", path.read_bytes())


@pytest.mark.parametrize("header", ["plain", "comments", "tabs"])
@pytest.mark.parametrize("magic", ["P5", "P6"])
def test_pnm_decodes_as_jax(magic, header, tmp_path):
    spp = 1 if magic == "P5" else 3
    px = np.random.default_rng(spp).integers(0, 256, 9 * 13 * spp,
                                             np.uint8).tobytes()
    head = {"plain": b" 13 9 255\n",
            "comments": b"\n# by hand\n13 #w\n 9\n255\n",
            "tabs": b"\t13\t9\t255 "}[header]
    held(tmp_path, "tex.pnm", magic.encode() + head + px)


def test_decoder_follows_the_leading_bytes_not_the_name(tmp_path):
    png = ti.random_png(1, 6, 5, 2, 8)
    jpg = ti.jpeg_bytes(ti.smooth_rgb(1, 6, 5))
    bmp = ti.bmp_bytes(2, 1, 24, [bytes(6)])
    for name, data in (("png.jpg", png), ("jpg.png", jpg), ("bmp.tga", bmp),
                       ("png", png)):
        held(tmp_path, name, data)


@pytest.mark.parametrize("fmt", ["png", "jpeg", "bmp", "tga", "pnm"])
def test_broken_file_is_none_as_in_jax(fmt, tmp_path):
    """A truncated file of a format decoded here returns None, as PIL's
    exception does in the JAX package."""
    x = ti.smooth_rgb(2, 20, 12)
    data = {"png": ti.random_png(2, 20, 12, 2, 8),
            "jpeg": ti.jpeg_bytes(x, progressive=True),
            "bmp": ti.bmp_bytes(20, 12, 24, [r.tobytes() for r in x]),
            "tga": ti.tga_bytes(20, 12, 10, 24, x.tobytes()),
            "pnm": b"P6 20 12 255\n" + x.tobytes()}[fmt]
    path = tmp_path / f"broken.{fmt}"
    path.write_bytes(data[:len(data) * 2 // 3])
    assert jimage.load_rgba(str(path)) is None
    assert image.load_rgba(str(path)) is None


# ---- refusals --------------------------------------------------------------

def _refused():
    x = ti.smooth_rgb(4, 16, 16)

    def pil(fmt, mode="RGB", **save):
        out = __import__("io").BytesIO()
        Image.fromarray(x).convert(mode).save(out, fmt, **save)
        return out.getvalue()

    base = ti.jpeg_bytes(x)
    prog = ti.jpeg_bytes(ti.smooth_rgb(5, 64, 48), progressive=True)
    return {
        "GIF": pil("GIF"), "TIFF": pil("TIFF"), "WebP": pil("WEBP"),
        "PSD": b"8BPS\x00\x01" + bytes(40),
        "CMYK JPEG": pil("JPEG", "CMYK"),
        "12-bit JPEG": ti.patch_frame(base, precision=12),
        "arithmetic-coded JPEG": ti.patch_frame(base, kind=0xC9),
        "lossless JPEG": ti.patch_frame(base, kind=0xC3),
        "progressive JPEG cut short": ti.drop_last_scan(prog),
        "RLE BMP": ti.bmp_bytes(4, 2, 8, [bytes(4)] * 2,
                                palette=bytes(1024), compression=1),
        "16-bit PNM": b"P6 4 2 65535\n" + bytes(48),
        "ASCII PNM": b"P3 1 1 255\n1 2 3\n",
    }


@pytest.mark.parametrize("fmt", list(_refused()))
def test_formats_not_decoded_raise_naming_the_file(fmt, tmp_path):
    path = tmp_path / "my_texture.bin"
    path.write_bytes(_refused()[fmt])
    with pytest.raises(NotImplementedError, match="my_texture.bin"):
        image.load_rgba(str(path))


# ---- the committed fixtures -----------------------------------------------

with open(os.path.join(DATA, "digests.json")) as _f:
    DIGESTS = json.load(_f)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_fixture_digests_equal_pil_and_the_port(name):
    """``tests/torch_data/digests.json`` (written by
    ``tools/make_torch_fixtures.py``) holds PIL's decode of each fixture,
    which ``chip_smoke.py`` holds the card machine's decode to; the 16-bit
    grey PNG's holds the high-byte image of the named deviation."""
    path = os.path.join(DATA, name)
    port = image.load_rgba8(path)
    assert list(port.shape) == DIGESTS[name]["shape"]
    assert (hashlib.sha256(port.tobytes()).hexdigest()
            == DIGESTS[name]["rgba_sha256"])
    with Image.open(path) as im:
        pil = np.asarray(im.convert("RGBA"), np.uint8)
    assert np.array_equal(pil, port) == (name != "grey16.png")


# ---- scenes ----------------------------------------------------------------

def jpeg_and_bmp(tmp_path):
    """Paths of a progressive 4:2:0 JPEG and a 24-bit BMP."""
    rough = tmp_path / "rough.jpg"
    rough.write_bytes(ti.jpeg_bytes(ti.smooth_rgb(11, 61, 47), quality=80,
                                    subsampling=2, progressive=True))
    normal = tmp_path / "normal.bmp"
    px = ti.smooth_rgb(12, 31, 23)
    normal.write_bytes(ti.bmp_bytes(31, 23, 24,
                                    [r[:, ::-1].tobytes() for r in px]))
    return str(rough), str(normal)


def jpeg_bmp_scene(tmp_path):
    """``glossy_textured_cornell`` of ``tests/test_torch_textures.py`` with
    a JPEG roughness map on both blocks and a BMP normal map on the back
    wall."""
    rough, normal = jpeg_and_bmp(tmp_path)
    sc = cornell_scene(depth=2, res=(16, 16),
                       block_types=(MaterialType.GLOSSY, MaterialType.GLOSSY))
    sc.set_roughness_texture(0, 6, rough)
    sc.set_roughness_texture(0, 7, rough)
    sc.set_normal_texture(0, 3, normal)
    return sc


@pytest.mark.parametrize("build_bvh", [False, True])
def test_compile_with_jpeg_and_bmp_maps_equals_jax(build_bvh, tmp_path):
    jsc = jpeg_bmp_scene(tmp_path)
    got = to_port_scene(jsc).compile("cpu", build_bvh=build_bvh)
    assert got.textures.shape == (2, 47, 61, 4)
    assert_fields_equal(jsc.compile(build_bvh=build_bvh), got)


@pytest.mark.parametrize("dispersion", [False, "hero"])
def test_jpeg_and_bmp_mapped_trace_matches_jax_under_one_key(dispersion,
                                                             tmp_path):
    """The glossy wall of ``normal_mapped_wall`` (no ray meets a mesh edge
    there, so every pixel is compared) with the JPEG roughness map and the
    BMP normal map."""
    rough, normal = jpeg_and_bmp(tmp_path)
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    assert jsc.objects[0].elements[0].material.type == MaterialType.GLOSSY
    got, want = trace_both(jsc, jsc.trace_depth, 3, dispersion)
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0
