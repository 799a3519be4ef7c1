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
states it). Last, ROADMAP Queue 3's faults: files that are no image
(None in both), the format named as PIL's plugin order names it, and
damaged PNG, TIFF, TGA and JPEG files as PIL reads them (the sweeps over
every fixture are ``tests/test_torch_damage.py``).
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
from test_torch_readers import fx  # noqa: E402
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


@pytest.mark.parametrize("fmt", ["png", "jpeg", "bmp", "tga", "pnm", "gif",
                                 "tiff-lzw", "tiff-raw", "tiff-deflate",
                                 "tiff-packbits", "psd-raw", "psd-rle"])
def test_broken_file_is_none_as_in_jax(fmt, tmp_path):
    """A truncated file of a format decoded here returns None, as PIL's
    exception does in the JAX package."""
    x = ti.smooth_rgb(2, 20, 12)
    data = {"png": ti.random_png(2, 20, 12, 2, 8),
            "jpeg": ti.jpeg_bytes(x, progressive=True),
            "bmp": ti.bmp_bytes(20, 12, 24, [r.tobytes() for r in x]),
            "tga": ti.tga_bytes(20, 12, 10, 24, x.tobytes()),
            "pnm": b"P6 20 12 255\n" + x.tobytes(),
            "gif": ti.gif_bytes(x[..., 0] >> 4, global_palette=bytes(48)),
            "tiff-lzw": ti.tiff_bytes(x, compression=5),
            "tiff-raw": ti.tiff_bytes(x, rows_per_strip=3),
            "tiff-deflate": ti.tiff_bytes(x, compression=8),
            "tiff-packbits": ti.tiff_bytes(x, compression=32773),
            "psd-raw": ti.psd_bytes(np.moveaxis(x, -1, 0), 3),
            "psd-rle": ti.psd_bytes(np.moveaxis(x, -1, 0), 3, rle=True)}[fmt]
    path = tmp_path / f"broken.{fmt}"
    path.write_bytes(data[:len(data) * 2 // 3])
    assert jimage.load_rgba(str(path)) is None
    assert image.load_rgba(str(path)) is None


# ---- GIF -------------------------------------------------------------------

def _palette(rng, n):
    return rng.integers(0, 256, 3 * n, np.uint8).tobytes()


GREY4 = bytes(v for i in range(4) for v in (i, i, i))


def _pil_gif(img, **save):
    out = __import__("io").BytesIO()
    img.save(out, "GIF", **save)
    return out.getvalue()


def _gif_cases():
    rng = np.random.default_rng(11)
    cases = {}
    for w, h in ((1, 1), (5, 3), (17, 9), (37, 29)):
        idx = rng.integers(0, 16, (h, w)).astype(np.uint8)
        pal = _palette(rng, 16)
        for version in (b"GIF87a", b"GIF89a"):
            v = version[3:].decode()
            cases[f"global-{v}-{w}x{h}"] = ti.gif_bytes(
                idx, global_palette=pal, version=version)
        cases[f"local-{w}x{h}"] = ti.gif_bytes(idx, local_palette=pal)
        cases[f"interlaced-{w}x{h}"] = ti.gif_bytes(
            idx, global_palette=pal, interlace=True)
        cases[f"transparent-{w}x{h}"] = ti.gif_bytes(
            idx, global_palette=pal, transparency=int(idx[0, 0]))
    idx = rng.integers(0, 4, (9, 7)).astype(np.uint8)
    pal4, pal16 = _palette(rng, 4), _palette(rng, 16)
    idx8 = rng.integers(0, 8, (9, 7)).astype(np.uint8)
    cases.update({
        "local-over-global": ti.gif_bytes(idx, global_palette=pal16,
                                          local_palette=pal4),
        "grey-local-over-global": ti.gif_bytes(idx, global_palette=pal16,
                                               local_palette=GREY4),
        "grey-ramp-table": ti.gif_bytes(idx, global_palette=GREY4),
        "no-table": ti.gif_bytes(idx8),
        "no-table-transparent": ti.gif_bytes(idx8, transparency=3),
        "indices-past-the-table": ti.gif_bytes(idx8, global_palette=pal4),
        "frame-inside-screen": ti.gif_bytes(idx, screen=(12, 14),
                                            offset=(3, 4),
                                            global_palette=pal4),
        "frame-inside-screen-transparent": ti.gif_bytes(
            idx, screen=(12, 14), offset=(3, 4), global_palette=pal4,
            transparency=2),
        "frame-past-screen": ti.gif_bytes(idx, screen=(5, 5), offset=(2, 1),
                                          local_palette=pal4),
        "interlaced-offset-transparent": ti.gif_bytes(
            rng.integers(0, 4, (21, 6)).astype(np.uint8), screen=(9, 30),
            offset=(1, 5), global_palette=pal4, interlace=True,
            transparency=1),
        "no-end-code": ti.gif_bytes(idx, global_palette=pal4, lzw=ti.gif_lzw(
            idx.reshape(-1), 2, end=False)),
        "wide-code-size": ti.gif_bytes(idx, global_palette=pal4, bits=8),
    })
    noise = rng.integers(0, 256, (90, 101)).astype(np.uint8)
    pal256 = _palette(rng, 256)
    cases["full-table-cleared"] = ti.gif_bytes(noise, global_palette=pal256)
    cases["full-table-without-clear"] = ti.gif_bytes(
        noise, global_palette=pal256,
        lzw=ti.gif_lzw(noise.reshape(-1), 8, clear_when_full=False))
    x = ti.smooth_rgb(12, 37, 29)
    img = Image.fromarray(x)
    cases.update({
        "pil-rgb": _pil_gif(img),
        "pil-rgb-not-interlaced": _pil_gif(img, interlace=0),
        "pil-grey": _pil_gif(img.convert("L")),
        "pil-p-transparent": _pil_gif(img.quantize(7), transparency=3),
        "pil-1": _pil_gif(img.convert("1")),
    })
    return cases


@pytest.mark.parametrize("case", list(_gif_cases()))
def test_gif_decodes_as_jax(case, tmp_path):
    held(tmp_path, "tex.gif", _gif_cases()[case])


# ---- TIFF ------------------------------------------------------------------

def _cmap(rng, bits):
    return rng.integers(0, 65536, 3 * (1 << bits)).tolist()


def _pil_tiff(img, **save):
    out = __import__("io").BytesIO()
    img.save(out, "TIFF", **save)
    return out.getvalue()


def _tiff_cases():
    rng = np.random.default_rng(12)
    cases = {}
    comps = {"raw": 1, "lzw": 5, "deflate": 8, "zip": 32946,
             "packbits": 32773}
    for order, o in (("<", "II"), (">", "MM")):
        for cname, comp in comps.items():
            x = ti.smooth_rgb(len(cases), 37, 29)
            cases[f"rgb-{cname}-{o}"] = ti.tiff_bytes(
                x, compression=comp, order=order, rows_per_strip=5)
            for bits in (1, 2, 4, 8):
                g = rng.integers(0, 1 << bits, (9, 17, 1))
                for photo in (0, 1):
                    cases[f"grey{bits}-photo{photo}-{cname}-{o}"] = \
                        ti.tiff_bytes(g, bits, photometric=photo,
                                      compression=comp, order=order,
                                      rows_per_strip=4)
                cases[f"palette{bits}-{cname}-{o}"] = ti.tiff_bytes(
                    g, bits, photometric=3, compression=comp, order=order,
                    colormap=_cmap(rng, bits))
        for comp in (5, 8):
            cname = {5: "lzw", 8: "deflate"}[comp]
            x8 = ti.smooth_rgb(3, 23, 11)
            x16 = rng.integers(0, 1 << 16, (11, 23, 3))
            g16 = rng.integers(0, 1 << 16, (11, 23, 4))
            cases[f"rgb8-predictor-{cname}-{o}"] = ti.tiff_bytes(
                x8, compression=comp, predictor=2, order=order,
                rows_per_strip=3)
            cases[f"rgb16-predictor-{cname}-{o}"] = ti.tiff_bytes(
                x16, 16, compression=comp, predictor=2, order=order)
            cases[f"grey8-predictor-{cname}-{o}"] = ti.tiff_bytes(
                x8[..., :1], compression=comp, predictor=2, order=order)
            for ex in (0, 1, 2):
                cases[f"rgba16-extra{ex}-{cname}-{o}"] = ti.tiff_bytes(
                    g16, 16, compression=comp, extra=[ex], order=order,
                    predictor=2)
            cases[f"tiled-rgb8-{cname}-{o}"] = ti.tiff_bytes(
                ti.smooth_rgb(4, 37, 29), compression=comp, tile=(16, 16),
                order=order, predictor=2)
            cases[f"tiled-planar-rgb16-{cname}-{o}"] = ti.tiff_bytes(
                x16, 16, compression=comp, tile=(16, 16), planar=2,
                order=order)
            cases[f"planar-rgba8-{cname}-{o}"] = ti.tiff_bytes(
                g16 >> 8, compression=comp, planar=2, extra=[2],
                order=order, rows_per_strip=4)
        rgba = rng.integers(0, 256, (7, 13, 4))
        rgba[0, :4, 3] = (0, 255, 1, 128)
        for ex in ((0,), (1,), (2,), (999,), None, (0, 0), (1, 0),
                   (2, 0, 0)):
            px = rgba if ex is None or len(ex) == 1 else np.concatenate(
                [rgba] + [rgba[..., :1]] * (len(ex) - 1), -1)
            cases[f"rgba8-extra{'-'.join(map(str, ex or ()))}-{o}"] = \
                ti.tiff_bytes(px, extra=ex, order=order)
        cases[f"grey-alpha-{o}"] = ti.tiff_bytes(rgba[..., :2], extra=[2],
                                                 order=order)
        cases[f"palette-alpha-{o}"] = ti.tiff_bytes(
            rgba[..., :2], photometric=3, extra=[2], order=order,
            colormap=_cmap(rng, 8))
        cases[f"palette-extra0-{o}"] = ti.tiff_bytes(
            rgba[..., :2], photometric=3, extra=[0], order=order,
            colormap=_cmap(rng, 8))
        f = (rng.standard_normal((5, 9, 1)) * 150 + 100).astype(np.float32)
        f[0, :4, 0] = (np.nan, np.inf, -np.inf, 255.5)
        for photo in (0, 1):
            cases[f"float32-photo{photo}-{o}"] = ti.tiff_bytes(
                f, 32, sample_format=3, photometric=photo, order=order)
        if order == "<":
            cases["float32-lzw-II"] = ti.tiff_bytes(
                f, 32, sample_format=3, compression=5, order=order)
        cases[f"planar-raw-rgb8-{o}"] = ti.tiff_bytes(
            ti.smooth_rgb(5, 13, 7), planar=2, order=order,
            rows_per_strip=3)
        cases[f"tiled-raw-grey8-{o}"] = ti.tiff_bytes(
            rng.integers(0, 256, (20, 35, 1)), tile=(16, 16), order=order)
        cases[f"fill-order2-grey8-{o}"] = ti.tiff_bytes(
            rng.integers(0, 256, (5, 7, 1)), fill_order=2, order=order)
        cases[f"fill-order2-grey1-lzw-{o}"] = ti.tiff_bytes(
            rng.integers(0, 2, (5, 19, 1)), 1, fill_order=2, compression=5,
            order=order)
    for w, h in ((1, 1), (17, 9), (37, 29)):
        x = ti.smooth_rgb(w * h, w, h)
        cases[f"rgb-lzw-{w}x{h}"] = ti.tiff_bytes(x, compression=5,
                                                  predictor=2)
    img = Image.fromarray(ti.smooth_rgb(13, 37, 29))
    for mode in ("1", "L", "RGB", "RGBA", "P", "LA"):
        im = img.quantize(9) if mode == "P" else img.convert(mode)
        for comp in ("raw", "tiff_lzw", "tiff_deflate", "packbits"):
            cases[f"pil-{mode}-{comp}"] = _pil_tiff(im, compression=comp)
    return cases


@pytest.mark.parametrize("case", list(_tiff_cases()))
def test_tiff_decodes_as_jax(case, tmp_path):
    held(tmp_path, "tex.tif", _tiff_cases()[case])


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("compression", [1, 5])
def test_16bit_grey_tiff_is_the_named_deviation(compression, order,
                                                tmp_path):
    """The 16-bit grey TIFF takes the 16-bit grey PNG's deviation: each
    sample keeps its high byte, where PIL opens mode I;16 and
    ``convert("RGBA")`` clips at 255."""
    samples = np.array([[0, 250, 500, 750, 6211, 55745, 65535]])[..., None]
    path = tmp_path / "grey16.tif"
    path.write_bytes(ti.tiff_bytes(samples, 16, compression=compression,
                                   order=order))
    got = image.load_rgba8(str(path))
    np.testing.assert_array_equal(got[0, :, 0], [0, 0, 1, 2, 24, 217, 255])
    assert (got[..., 1:3] == got[..., :1]).all() and (got[..., 3] == 255).all()
    pil = np.round(jimage.load_rgba(str(path)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(pil[0, :, 0],
                                  [0, 250, 255, 255, 255, 255, 255])


def test_tiff_modes_are_pils(tmp_path):
    """The port's table of the TIFF keys PIL opens (``_tiff_mode``) names
    the mode PIL's OPEN_INFO gives every key, and no other key."""
    from PIL import TiffImagePlugin as T
    for key, (mode, _) in T.OPEN_INFO.items():
        order = "<" if key[0] == T.II else ">"
        assert image._tiff_mode(order, *key[1:]) == mode, key
    keys = set(T.OPEN_INFO)
    for prefix, order in ((T.II, "<"), (T.MM, ">")):
        for photo in range(10):
            for sf in ((1,), (2,), (3,)):
                for fill in (1, 2):
                    for bps in ((1,), (2,), (4,), (8,), (12,), (16,), (32,),
                                (8, 8), (8,) * 3, (8,) * 4, (8,) * 5,
                                (8,) * 6, (16,) * 3, (16,) * 4):
                        for extra in ((), (0,), (1,), (2,), (0, 0), (1, 0),
                                      (2, 0), (999,), (2, 0, 0)):
                            key = (prefix, photo, sf, fill, bps, extra)
                            got = image._tiff_mode(order, photo, sf, fill,
                                                   bps, extra)
                            assert (got is not None) == (key in keys), key


# ---- PSD -------------------------------------------------------------------

def _psd_cases():
    rng = np.random.default_rng(13)
    cases = {}
    for w, h in ((1, 1), (5, 3), (37, 29)):
        for rle in (False, True):
            r = "rle" if rle else "raw"
            ch = lambda n: rng.integers(0, 256, (n, h, w))   # noqa: E731
            runs = ch(4)
            runs[:, :, : w // 2] = 77                        # runs for RLE
            cases[f"rgb-{r}-{w}x{h}"] = ti.psd_bytes(runs[:3], 3, rle=rle)
            cases[f"rgba-{r}-{w}x{h}"] = ti.psd_bytes(runs, 3, rle=rle)
            cases[f"grey-{r}-{w}x{h}"] = ti.psd_bytes(ch(1), 1, rle=rle)
            cases[f"cmyk-{r}-{w}x{h}"] = ti.psd_bytes(ch(4), 4, rle=rle)
            cases[f"indexed-{r}-{w}x{h}"] = ti.psd_bytes(
                ch(1), 2, rle=rle, palette=_palette(rng, 256))
            cases[f"bitmap-{r}-{w}x{h}"] = ti.psd_bytes(
                rng.integers(0, 2, (1, h, w)), 0, depth=1, rle=rle)
    ch = rng.integers(0, 256, (5, 6, 9))
    cases.update({
        "rgb-five-channels": ti.psd_bytes(ch, 3, rle=True),
        "cmyk-five-channels": ti.psd_bytes(ch, 4),
        "grey-two-channels": ti.psd_bytes(ch[:2], 1, rle=True),
        "bitmap-mode-8bit": ti.psd_bytes(ch[:1], 0),
        "multichannel": ti.psd_bytes(ch[:3], 7),
        "duotone": ti.psd_bytes(ch[:1], 8, palette=bytes(20)),
        "indexed-without-palette": ti.psd_bytes(ch[:1], 2),
        "rgb-with-layers": ti.psd_bytes(ch[:3], 3, rle=True,
                                        layers=bytes(range(40))),
    })
    return cases


@pytest.mark.parametrize("case", list(_psd_cases()))
def test_psd_decodes_as_jax(case, tmp_path):
    held(tmp_path, "tex.psd", _psd_cases()[case])


@pytest.mark.parametrize("case", ["16-bit", "version-2"])
def test_psd_pil_refuses_is_none_as_in_jax(case, tmp_path):
    ch = np.random.default_rng(3).integers(0, 256, (3, 4, 5))
    data = ti.psd_bytes(ch, 3, depth=16) if case == "16-bit" else (
        ti.psd_bytes(ch, 3)[:4] + b"\0\x02" + ti.psd_bytes(ch, 3)[6:])
    path = tmp_path / "x.psd"
    path.write_bytes(data)
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
    # a JP2 file whose COD sets the SOP bit (PIL reads it: SOP is
    # optional), and a 16-bit grey one (PIL's I;16)
    sop = bytearray(pil("JPEG2000"))
    sop[sop.index(b"\xff\x52") + 4] |= 2
    sop = bytes(sop)
    grey16 = __import__("io").BytesIO()
    Image.frombytes("I;16", (16, 16), (x[..., 0].astype("<u2") * 257)
                    .tobytes()).save(grey16, "JPEG2000")
    cmyk = np.concatenate([ti.smooth_rgb(6, 40, 24),
                           ti.smooth_rgb(7, 40, 24)[..., :1]], -1)
    return {
        "old-style JPEG-in-TIFF": ti.tiff_bytes(
            x, photometric=6, compression=6, chunks=[base]),
        "CCITT RLEW TIFF": pil("TIFF", "1", compression="tiff_raw_16"),
        "YCbCr LZW TIFF subsampled 2x2": ti.tiff_bytes(
            x, photometric=6, compression=5, extra_tags=((530, 3, [2, 2]),)),
        "CIELab PSD": ti.psd_bytes(np.moveaxis(x, -1, 0), 9),
        "AVIF writer": ".avif",
        # JPEG 2000 files PIL reads and the decoder refuses (every save
        # option of PIL's but the cinema profiles is decoded)
        "JPEG 2000 with SOP markers": sop,
        "16-bit JPEG 2000": grey16.getvalue(),
        # an ICNS whose best entry is one of them
        "JPEG 2000 ICNS entry with SOP markers": b"icns" + struct.pack(
            ">I", 16 + len(sop)) + b"ic09" + struct.pack(
                ">I", 8 + len(sop)) + sop,
        "lossless JPEG": ti.patch_frame(base, kind=0xC3),
        "lossless JPEG by libjpeg": ti.libjpeg_bytes(x, lossless=True),
        "progressive JPEG cut short": ti.drop_last_scan(prog),
        "arithmetic progressive JPEG cut short": ti.drop_last_scan(
            ti.libjpeg_bytes(ti.smooth_rgb(5, 64, 48), arith=True,
                             progressive=True)),
        "CMYK progressive JPEG cut short": ti.drop_last_scan(
            ti.libjpeg_bytes(cmyk, "cmyk", progressive=True)),
        **{f"IM {typ} image": f"Image type: {typ} image\r\nImage size (x*y): "
           f"4*2\r\n\x1a".encode() + bytes(64)
           for typ in ("B2", "RLB", "X 24", "RGB3", "L 32 F", "L 8",
                       "L*12")},
        "ASCII PNM": b"P3 1 1 255\n1 2 3\n",
        "ASCII PBM": b"P1 3 1\n0 1 0\n",
        # the 3 formats PIL opens and the port does not decode
        **{f"{fmt} file": data for fmt, data in STILL_REFUSED.items()},
    }


# {format: a file the port names as it and refuses}
STILL_REFUSED = {
    "AVIF": b"\0\0\0\x1cftypavif" + bytes(60),
    "EPS": b"%!PS-Adobe-3.0 EPSF-3.0\n" + bytes(40),
    "WMF": b"\xd7\xcd\xc6\x9a\x00\x00" + bytes(60),
}


@pytest.mark.parametrize("fmt", sorted(STILL_REFUSED))
def test_refused_formats_are_named_as_pil_names_them(fmt):
    """Each of the 3 formats still refused is the format PIL's plugin
    tests name (so its file raises naming it, not None)."""
    assert image._sniff(STILL_REFUSED[fmt]) == fmt


# {format: a file the port once refused as that format, which PIL cannot
# identify: an FLI header with no frame header after it (PIL's read of
# the frame's type is a struct.error), an IPTC record without a (3, 60)
# field, a PCD marker in a file shorter than PIL's 1,539-byte read}
ONCE_REFUSED_UNIDENTIFIED = {
    "FLI": bytes(4) + b"\x11\xaf" + bytes(122),
    "IPTC": b"\x1c\x02\x00\x00\x02ab" + bytes(20),
    "PCD": bytes(2048) + b"PCD_" + bytes(100),
}


@pytest.mark.parametrize("fmt", sorted(ONCE_REFUSED_UNIDENTIFIED))
def test_files_once_refused_as_fli_iptc_pcd_are_none_as_in_jax(fmt,
                                                                tmp_path):
    """The three files the port refused by a prefix test: each plugin's
    whole ``_open`` fails as PIL's does, no other plugin opens the file,
    and both packages give None (``utils/fli_pcd_iptc.py``)."""
    data = ONCE_REFUSED_UNIDENTIFIED[fmt]
    assert image._sniff(data) is None
    path = tmp_path / "x.bin"
    path.write_bytes(data)
    assert jimage.load_rgba(str(path)) is None
    assert image.load_rgba(str(path)) is None


# {format: a file of it, once refused, that the port now decodes
# (``utils/bitmaps.py`` and ``utils/fli_pcd_iptc.py``;
# ``tests/test_torch_bitmap_formats.py`` and
# ``tests/test_torch_fli_pcd_iptc.py`` hold the rest)}
NOW_DECODED = {
    "FLI": fx.fli_bytes(5, 3, [fx.fli_frame([fx.fli_chunk(
        15, fx.fli_brun(np.arange(15, dtype=np.uint8).reshape(3, 5)))])]),
    "IPTC": fx.iptc_bytes(5, 3, bytes(range(40, 55))),
    "PCD": fx.pcd_bytes(*fx.pcd_of(fx.procedural_rgb(768, 512, 29), 29),
                        orientation=1),
    "GBR": struct.pack(">5I", 28, 2, 4, 4, 1) + b"GIMP" + bytes(80),
    "MSP": fx.msp_bytes(np.eye(8, dtype=np.uint8)),
    "SUN": struct.pack(">8I", 0x59A66A95, 4, 4, 8, 16, 1, 0, 0)
    + bytes(range(16)),
    "XBM": b"#define x_width 8\n#define x_height 1\n"
           b"static char x_bits[] = {0x5a};\n",
    "XPM": b'/* XPM */\nstatic char *x[] = {\n"1 1 1 1",\n"a c #000000",\n'
           b'"a"};\n',
}


@pytest.mark.parametrize("fmt", sorted(NOW_DECODED))
def test_formats_once_refused_are_named_and_decoded_as_jax(fmt, tmp_path):
    """FLI, GBR, IPTC, MSP, PCD, SUN, XBM and XPM, refused before
    ``utils/bitmaps.py`` and ``utils/fli_pcd_iptc.py``: named as PIL's
    plugin tests name them and decoded as the JAX package decodes
    them."""
    assert image._sniff(NOW_DECODED[fmt]) == fmt
    held(tmp_path, "x.bin", NOW_DECODED[fmt])


@pytest.mark.parametrize("bits", [12, 16])
def test_12_and_16_bit_jpeg_frames_are_none_as_in_jax(bits, tmp_path):
    """PIL's SOF handler raises "cannot handle 12-bit layers" and no other
    plugin opens the file, so the JAX package gives None; the port gives
    None too (it refused the flavour before)."""
    path = tmp_path / "x.jpg"
    path.write_bytes(ti.patch_frame(ti.jpeg_bytes(ti.smooth_rgb(4, 16, 16)),
                                    precision=bits))
    assert jimage.load_rgba(str(path)) is None
    assert image.load_rgba(str(path)) is None


def test_arithmetic_lossless_jpeg_is_none_as_in_jax(tmp_path):
    """libjpeg-turbo decodes no arithmetic-coded lossless frame (SOF11; it
    writes none either): None in both packages."""
    path = tmp_path / "x.jpg"
    path.write_bytes(ti.patch_frame(ti.libjpeg_bytes(
        ti.smooth_rgb(4, 16, 16), arith=True), kind=0xCB))
    assert jimage.load_rgba(str(path)) is None
    assert image.load_rgba(str(path)) is None


@pytest.mark.parametrize("fmt", list(_refused()))
def test_formats_not_decoded_raise_naming_the_file(fmt, tmp_path):
    """Files the port does not decode, and (an extension in place of the
    bytes) formats ``write_image`` does not write."""
    case = _refused()[fmt]
    if isinstance(case, str):
        with pytest.raises(NotImplementedError, match="my_texture"):
            image.write_image(str(tmp_path / f"my_texture{case}"),
                              np.zeros((2, 3), np.uint8))
        return
    path = tmp_path / "my_texture.bin"
    path.write_bytes(case)
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
    grey PNG's, TIFF's and P5's hold the high-byte image of the named
    deviation, the 12-bit grey TIFF's its top-8-bit image."""
    path = os.path.join(DATA, name)
    port = image.load_rgba8(path)
    assert list(port.shape) == DIGESTS[name]["shape"]
    assert (hashlib.sha256(port.tobytes()).hexdigest()
            == DIGESTS[name]["rgba_sha256"])
    with Image.open(path) as im:
        pil = np.asarray(im.convert("RGBA"), np.uint8)
    assert np.array_equal(pil, port) == (
        not name.startswith(("grey16.", "grey12.")))


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


def tiff_and_gif(tmp_path):
    """Paths of a 16-bit RGB LZW TIFF with predictor 2 and an interlaced
    GIF with a 256-entry table."""
    rough = tmp_path / "rough.tif"
    rng = np.random.default_rng(14)
    deep = ti.smooth_rgb(13, 61, 47).astype(np.int64) * 257 \
        + rng.integers(0, 257, (47, 61, 3))
    rough.write_bytes(ti.tiff_bytes(deep, 16, compression=5, predictor=2,
                                    rows_per_strip=8))
    normal = tmp_path / "normal.gif"
    idx = (ti.smooth_rgb(14, 31, 23)[..., 0] // 16).astype(np.uint8)
    pal = np.concatenate([ti.smooth_rgb(15, 16, 1)[0],
                          np.zeros((240, 3), np.uint8)]).tobytes()
    normal.write_bytes(ti.gif_bytes(idx, global_palette=pal, interlace=True))
    return str(rough), str(normal)


@pytest.mark.parametrize("build_bvh", [False, True])
def test_compile_with_tiff_and_gif_maps_equals_jax(build_bvh, tmp_path):
    rough, normal = tiff_and_gif(tmp_path)
    jsc = cornell_scene(depth=2, res=(16, 16),
                        block_types=(MaterialType.GLOSSY, MaterialType.GLOSSY))
    jsc.set_roughness_texture(0, 6, rough)
    jsc.set_roughness_texture(0, 7, rough)
    jsc.set_normal_texture(0, 3, normal)
    got = to_port_scene(jsc).compile("cpu", build_bvh=build_bvh)
    assert got.textures.shape == (2, 47, 61, 4)
    assert_fields_equal(jsc.compile(build_bvh=build_bvh), got)


@pytest.mark.parametrize("dispersion", [False, "hero"])
def test_tiff_and_gif_mapped_trace_matches_jax_under_one_key(dispersion,
                                                             tmp_path):
    """``test_jpeg_and_bmp_mapped_trace_matches_jax_under_one_key`` with
    the TIFF roughness map and the GIF normal map (rtol 1e-4 / atol
    1e-6)."""
    rough, normal = tiff_and_gif(tmp_path)
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    got, want = trace_both(jsc, jsc.trace_depth, 3, dispersion)
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


# ---- files that are no image, and damaged ones (ROADMAP Queue 3) --------

def both_none(tmp_path, name: str, data: bytes) -> None:
    """The port and the JAX package both give None for ``data``."""
    path = tmp_path / name
    path.write_bytes(data)
    assert jimage.load_rgba(str(path)) is None
    assert image.load_rgba(str(path)) is None


CHECKER = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "checker.png")


def _not_images():
    rng = np.random.default_rng(21)
    return {
        "html-as-png": ("t.png", b"<!DOCTYPE html>\n<html><head><title>404 "
                                 b"Not Found</title></head></html>\n"),
        "zeros": ("t.png", bytes(64)),
        "random": ("t.jpg", rng.integers(0, 256, 4096, np.uint8).tobytes()),
        "riff-wave": ("t.webp", b"RIFF" + struct.pack("<I", 36) + b"WAVEfmt "
                      + struct.pack("<IHHIIHH", 16, 1, 1, 8000, 8000, 1, 8)
                      + b"data" + bytes(4)),
        "riff-webp-without-image": ("t.webp", b"RIFF" + struct.pack("<I", 12)
                                    + b"WEBPALPH" + bytes(4)),
        "text": ("t.tif", b"width 37\nheight 29\n"),
        "empty": ("t.png", b""),
    }


@pytest.mark.parametrize("case", list(_not_images()))
def test_files_that_are_no_image_are_none_as_in_jax(case, tmp_path):
    """Bytes no PIL plugin opens give None, as PIL's exception does in the
    JAX package (before the repair the port raised NotImplementedError on
    all of them)."""
    both_none(tmp_path, *_not_images()[case])


@pytest.mark.parametrize("name", sorted(DIGESTS) + ["checker.png"])
def test_files_cut_inside_their_magic_are_none_as_in_jax(name, tmp_path):
    path = CHECKER if name == "checker.png" else os.path.join(DATA, name)
    data = open(path, "rb").read()
    for n in range(1, 12):
        both_none(tmp_path, name, data[:n])


def _pil_written():
    """{PIL's format: a small file of it PIL writes} for every format PIL
    12.1 writes (as RGB, else L)."""
    out = {}
    Image.init()
    rgb = ti.smooth_rgb(22, 16, 8)
    # (SpiderImagePlugin registers the extension of the name it saves
    # under, "" for a buffer: put PIL's table back after)
    extensions = dict(Image.EXTENSION)
    for fmt in sorted(Image.SAVE):
        for img in (Image.fromarray(rgb), Image.fromarray(rgb[..., 0]),
                    Image.fromarray(rgb[..., 0] > 128)):
            buf = __import__("io").BytesIO()
            try:
                img.save(buf, fmt)
            except Exception:  # noqa: BLE001 (no handler, or not this mode)
                continue
            try:                          # (PIL writes PDF, but opens no
                Image.open(buf).load()    # PDF, Palm or these ICOs)
            except Exception:  # noqa: BLE001
                break
            out[fmt] = buf.getvalue()
            break
    Image.EXTENSION.clear()
    Image.EXTENSION.update(extensions)
    return out


PIL_WRITTEN = _pil_written()


@pytest.mark.parametrize("fmt", sorted(PIL_WRITTEN))
def test_the_port_names_the_format_pil_opens(fmt):
    """For a file of every format PIL writes, the port's sniffing (PIL's
    plugin tests, in PIL's order) names the format PIL opens it as."""
    data = PIL_WRITTEN[fmt]
    with Image.open(__import__("io").BytesIO(data)) as im:
        want = im.format
    assert image._sniff(data) == want


def test_the_port_lists_pils_plugins_in_pils_order():
    """The port's table holds PIL 12.1's 43 opening plugins: Image.preinit's
    first, then the rest in the order Image.init registers them."""
    Image.init()
    names = [name for name, _ in image._PIL_OPENS]
    assert sorted(names) == sorted(Image.OPEN)
    preinit = ["BMP", "DIB", "GIF", "JPEG", "PPM", "PNG"]
    assert names[:6] == preinit
    assert names[6:] == [n for n in Image.ID if n not in preinit]


def test_formats_pil_opens_and_the_port_does_not_raise(tmp_path):
    """Every format PIL writes and the port does not decode raises
    NotImplementedError naming the file (never None)."""
    decoded = {"PNG", "JPEG", "BMP", "DIB", "TGA", "PPM", "GIF", "TIFF",
               "PSD", "WEBP", "SGI", "PCX", "IM", "QOI", "DDS", "ICO",
               "CUR", "ICNS", "JPEG2000", "SPIDER", "MSP", "XBM"}
    for fmt, data in PIL_WRITTEN.items():
        if Image.open(__import__("io").BytesIO(data)).format in decoded:
            continue
        path = tmp_path / f"my_{fmt}.bin"
        path.write_bytes(data)
        with pytest.raises(NotImplementedError, match=f"my_{fmt}.bin"):
            image.load_rgba(str(path))


def _png_without(data: bytes, kind: bytes) -> bytes:
    out, pos = data[:8], 8
    while pos < len(data):
        n = struct.unpack(">I", data[pos:pos + 4])[0]
        if data[pos + 4:pos + 8] != kind:
            out += data[pos:pos + 12 + n]
        pos += 12 + n
    return out


@pytest.mark.parametrize("damage", ["no-IEND", "IDAT-CRC", "IEND-CRC",
                                    "IHDR-CRC"])
def test_png_crcs_and_iend_as_pil_reads_them(damage, tmp_path):
    """PIL checks the CRC of the chunks before the image data and of none
    after, and needs no IEND; the port copies it (before the repair it
    checked every CRC and needed IEND)."""
    data = bytearray(open(CHECKER, "rb").read())
    if damage == "no-IEND":
        data = bytearray(_png_without(bytes(data), b"IEND"))
    else:
        kind = damage.split("-")[0].encode()
        at = bytes(data).find(kind) - 4
        n = struct.unpack(">I", data[at:at + 4])[0]
        data[at + 8 + n] ^= 0x40          # the chunk's CRC
    if damage == "IHDR-CRC":
        both_none(tmp_path, "t.png", bytes(data))
    else:
        held(tmp_path, "t.png", bytes(data))


def test_tiff_entry_count_past_the_file_reads_the_entries_that_fit(
        tmp_path):
    """PIL reads the IFD entries that fit in the file (before the repair
    the port gave None)."""
    px = ti.smooth_rgb(23, 9, 7)[..., 0].tobytes()
    entries = [(256, 3, 1, 9), (257, 3, 1, 7), (258, 3, 1, 8),
               (259, 3, 1, 1), (262, 3, 1, 1), (273, 4, 1, 8),
               (277, 3, 1, 1), (278, 3, 1, 7), (279, 4, 1, len(px))]
    ifd = struct.pack("<H", len(entries) + 300) + b"".join(
        struct.pack("<HHI", t, k, n) + struct.pack("<H" if k == 3 else "<I",
                                                   v).ljust(4, b"\0")
        for t, k, n, v in entries)                # the IFD last, cut short
    data = b"II*\0" + struct.pack("<I", 8 + len(px)) + px + ifd
    held(tmp_path, "t.tif", data)


@pytest.mark.parametrize("packet", ["run-across-rows", "run-past-the-end",
                                    "raw-across-rows"])
def test_tga_packets_as_pil_reads_them(packet, tmp_path):
    """PIL's TGA decoder overruns on a run packet that crosses a row (the
    image's end included) and returns None in the JAX package; a raw
    packet may cross rows (before the repair the port decoded both)."""
    px = bytes([10, 20, 30, 40])
    if packet == "run-across-rows":       # 4x2: one run of 8 pixels
        body = bytes([0x80 | 7]) + px
    elif packet == "run-past-the-end":    # a row, then a run of 5 for 4
        body = bytes([3]) + px * 4 + bytes([0x80 | 4]) + px
    else:                                 # one raw packet of all 8
        body = bytes([7]) + bytes(range(32))
    head = struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, 4, 2, 32,
                       0x08)
    data = head + body
    if packet == "raw-across-rows":
        held(tmp_path, "t.tga", data)
    else:
        both_none(tmp_path, "t.tga", data)


def test_jpeg_with_a_large_quantiser_decodes_as_jax(tmp_path):
    """A DQT value of 8 raised to 136: the dequantised coefficients leave
    16 bits, where libjpeg-turbo's SIMD IDCT wraps (the port copies it;
    before the repair 8 pixels differed)."""
    data = bytearray(ti.jpeg_bytes(ti.smooth_rgb(5, 56, 40)))
    at = bytes(data).find(b"\xff\xdb") + 5
    k = next(i for i in range(64) if data[at + i] == 8)
    data[at + k] = 136
    held(tmp_path, "t.jpg", bytes(data))


@pytest.mark.parametrize("kind", ["cut", "flip"])
def test_damaged_baseline_jpeg_agrees_with_jax(kind, tmp_path):
    """Every cut, and a flipped bit of every byte, of a 56x40 baseline
    JPEG: None in both packages or the same image."""
    data = ti.jpeg_bytes(ti.smooth_rgb(5, 56, 40))
    path = tmp_path / "t.jpg"
    for i in range(len(data)):
        if kind == "cut":
            case = data[:i]
        else:
            case = bytearray(data)
            case[i] ^= 1 << (i * 3 % 8)
        path.write_bytes(bytes(case))
        want = jimage.load_rgba(str(path))
        got = image.load_rgba(str(path))
        assert (got is None) == (want is None), (kind, i)
        if got is not None:
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32))
