"""The port's DIB, SGI, PCX and IM readers against the JAX package's
``load_rgba`` (PIL 12.1), bit for bit (tolerance 0): every mode PIL's
writers make in each format and the flavours PIL reads besides (BMP
bitfields in a DIB, SGI RLE at 1 and 2 bytes a sample, all 8 SGI modes,
PCX at 1 bit in 1, 2 or 4 planes, its palettes and strides, IM palettes
from a ``Lut``), sizes 1x1 to 37x29 with odd widths and a PCX stride that
is odd, the damaged files PIL reads or refuses, the IM image types the
port refuses, and the named deviation of 16-bit grey IM files (the high
byte, where PIL clips at 255). Then the host library's SGI and PCX
run-length decoders alone (``utils/codecs.py``) on the packets that test
their bounds, each held to PIL's decode of the same file; every file
``write_image`` writes under ``.dib .im .sgi .bw .rgb .rgba .pcx`` read
back; a scene with an RLE SGI roughness map and a PCX normal map compiled
and traced under one key against the JAX package (rtol 1e-4 / atol 1e-6,
as ``tests/test_torch_spectral.py`` states it); and a render from those
maps in a process that refuses to import jax and PIL.
"""

import importlib.util
import io
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
from pathtracing_spectrum_tpu_torch.utils import codecs, image  # noqa: E402

import torch_images as ti  # noqa: E402
from scene_helpers import cornell_scene  # noqa: E402
from test_torch_scene import assert_fields_equal, to_port_scene  # noqa: E402,E501
from test_torch_spectral import assert_same, trace_both  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_torch_fixtures", os.path.join(REPO, "tools",
                                        "make_torch_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

SIZES = [(1, 1), (5, 7), (2, 3), (37, 29)]      # (W, H): odd widths


def held(tmp_path, name: str, data: bytes) -> np.ndarray:
    """The port's RGBA8 of ``data`` written as ``name``, held bitwise to
    the JAX package's (which must read it); returns it."""
    path = tmp_path / name
    path.write_bytes(data)
    got, want = image.load_rgba(str(path)), jimage.load_rgba(str(path))
    assert want is not None, "PIL does not read this case"
    assert got is not None and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    return image.load_rgba8(str(path))


def as_jax(tmp_path, name: str, data: bytes) -> None:
    """The port gives what the JAX package gives: the same pixels, or None
    in both."""
    path = tmp_path / name
    path.write_bytes(data)
    want = jimage.load_rgba(str(path))
    got = image.load_rgba(str(path))
    if want is None:
        assert got is None
    else:
        assert got is not None and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def pil_file(img, fmt: str, **save) -> bytes:
    out = io.BytesIO()
    img.save(out, fmt, **save)
    return out.getvalue()


def pixels(w: int, h: int, bands: int, seed: int) -> np.ndarray:
    """Noise with runs: half of each row held at one value."""
    px = np.random.default_rng(seed).integers(0, 256, (h, w, bands),
                                              np.uint8)
    px[:, :w // 2] = px[:, :1]
    return px


def pil_image(mode: str, w: int, h: int, seed: int):
    """A PIL image of ``mode`` (every mode one of the writers makes)."""
    rng = np.random.default_rng(seed)
    rgb = pixels(w, h, 3, seed)
    if mode == "P":
        return Image.fromarray(rgb).quantize(13)
    if mode == "PA":
        return Image.fromarray(rgb).quantize(9).convert("PA")
    if mode == "I":
        return Image.fromarray(rng.integers(-300, 600, (h, w), np.int32))
    if mode == "F":
        return Image.fromarray(
            (rng.random((h, w)) * 400 - 50).astype(np.float32))
    if mode in ("CMYK", "RGBX", "RGBA", "YCbCr"):
        return Image.frombytes(mode, (w, h), pixels(
            w, h, 3 if mode == "YCbCr" else 4, seed).tobytes())
    if mode.startswith("I;16"):
        dt = ">u2" if mode == "I;16B" else "<u2"
        return Image.frombytes(mode, (w, h), rng.integers(
            0, 256, (h, w)).astype(dt).tobytes())
    return Image.fromarray(rgb).convert(mode)


# ---- DIB ---------------------------------------------------------------------

def _dib_cases():
    cases = {}
    for w, h in SIZES:
        for mode in ("1", "L", "P", "RGB", "RGBA"):
            img = (Image.fromarray(pixels(w, h, 4, 1)) if mode == "RGBA"
                   else pil_image(mode, w, h, 1))
            cases[f"pil-{mode}-{w}x{h}"] = pil_file(img, "DIB")
    w, h = 7, 5
    rng = np.random.default_rng(2)
    quad = rng.integers(0, 256, (h, w, 4), np.uint8)
    p16 = rng.integers(0, 1 << 16, (h, w)).astype("<u2")
    for top in (False, True):
        o = "top-down" if top else "bottom-up"
        for masks, header in (((0xFF0000, 0xFF00, 0xFF, 0), 40),
                              ((0xFF0000, 0xFF00, 0xFF, 0), 124),
                              ((0xFF, 0xFF00, 0xFF0000, 0xFF000000), 124)):
            cases[f"32-bitfields-{masks[3]:x}-{header}-{o}"] = ti.bmp_bytes(
                w, h, 32, [r.tobytes() for r in quad], header=header,
                compression=3, masks=masks, top_down=top)[14:]
        for masks in ((0xF800, 0x7E0, 0x1F, 0), (0x7C00, 0x3E0, 0x1F, 0)):
            cases[f"16-bitfields-{masks[0]:x}-{o}"] = ti.bmp_bytes(
                w, h, 16, [r.tobytes() for r in p16], compression=3,
                masks=masks, top_down=top)[14:]
        cases[f"24-bitfields-{o}"] = ti.bmp_bytes(
            w, h, 24, [r[:, :3].tobytes() for r in quad], compression=3,
            masks=(0xFF0000, 0xFF00, 0xFF, 0), top_down=top)[14:]
    for bits in (1, 4, 8):
        for header, colors in ((12, 0), (40, 3), (40, 0)):
            n = colors or 1 << bits
            pad = 3 if header == 12 else 4
            pal = rng.integers(0, 256, n * pad, np.uint8).tobytes()
            idx = rng.integers(0, min(n, 1 << bits), (h, w)).astype(np.uint8)
            rows = [np.packbits(np.unpackbits(r[:, None], axis=1)[
                :, 8 - bits:].reshape(-1)).tobytes() for r in idx]
            cases[f"{bits}-palette-{header}-{colors or 'full'}"] = \
                ti.bmp_bytes(w, h, bits, rows, palette=pal, header=header,
                             colors=colors)[14:]
    return cases


DIB_CASES = _dib_cases()


@pytest.mark.parametrize("case", sorted(DIB_CASES))
def test_dib_decodes_as_jax(case, tmp_path):
    held(tmp_path, "tex.dib", DIB_CASES[case])


def test_dib_pixels_start_where_the_palette_ends(tmp_path):
    """A DIB has no file header to point at its pixels: PIL starts them
    where its reads end, after the header, the masks and the palette
    (here a palette of 3 entries, not 256)."""
    data = DIB_CASES["8-palette-40-3"]
    got = held(tmp_path, "tex.dib", data)
    pal = np.frombuffer(data, np.uint8, 12, 40).reshape(3, 4)[:, 2::-1]
    assert {tuple(p) for p in got[..., :3].reshape(-1, 3)} <= {
        tuple(p) for p in pal}


@pytest.mark.parametrize("damage", ["cut-in-header", "cut-in-palette",
                                    "cut-in-pixels", "bits-3",
                                    "palette-70000", "width-0"])
def test_damaged_dib_as_jax(damage, tmp_path):
    data = bytearray(DIB_CASES["8-palette-40-full"])
    if damage == "cut-in-header":
        data = data[:30]
    elif damage == "cut-in-palette":
        data = data[:40 + 500]
    elif damage == "cut-in-pixels":
        data = data[:-9]
    elif damage == "bits-3":
        struct.pack_into("<H", data, 14, 3)
    elif damage == "palette-70000":
        struct.pack_into("<I", data, 32, 70000)
    else:
        struct.pack_into("<I", data, 4, 0)
    as_jax(tmp_path, "tex.dib", bytes(data))
    assert image.load_rgba(str(tmp_path / "tex.dib")) is None


# ---- SGI -------------------------------------------------------------------

SGI_MODES = [(1, 1, 1), (1, 2, 1), (2, 1, 1), (2, 2, 1), (1, 3, 3),
             (2, 3, 3), (1, 3, 4), (2, 3, 4)]


def sgi_verbatim(px: np.ndarray, bpc: int, dimension: int) -> bytes:
    """A verbatim SGI file of [H, W, Z] samples (each channel's rows
    bottom-up), its header's dimension ``dimension``."""
    h, w, z = px.shape
    head = (struct.pack(">hBBHHHHll4s79ss", 474, 0, bpc, dimension, w, h, z,
                        0, 255, b"", b"x", b"")
            + struct.pack(">l404s", 0, b""))
    planes = np.moveaxis(px[::-1], -1, 0)
    return head + np.ascontiguousarray(planes).astype(
        ">u2" if bpc == 2 else np.uint8).tobytes()


def sgi_samples(w: int, h: int, z: int, bpc: int, seed: int) -> np.ndarray:
    px = pixels(w, h, z, seed).astype(np.int64)
    if bpc == 2:
        px = px * 257 + np.random.default_rng(seed).integers(0, 257, px.shape)
    return px.astype(np.uint16 if bpc == 2 else np.uint8)


def sgi_rle(px: np.ndarray, bpc: int, dimension: int = None) -> bytes:
    data = bytearray(fx.sgi_rle_bytes(px, b"x", bpc))
    if dimension is not None:
        struct.pack_into(">H", data, 4, dimension)
    return bytes(data)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("rle", [False, True], ids=["verbatim", "rle"])
@pytest.mark.parametrize("mode", SGI_MODES, ids=lambda m: "%d-%d-%d" % m)
def test_sgi_modes_decode_as_jax(mode, rle, size, tmp_path):
    """All 8 entries of PIL's ``MODES`` (bytes a sample, dimension,
    channels), verbatim and RLE: at 2 bytes the high byte, as PIL's
    ``;16B`` rawmodes keep it."""
    bpc, dimension, z = mode
    px = sgi_samples(*size, z, bpc, seed=z + 4 * bpc)
    data = (sgi_rle(px, bpc, dimension) if rle
            else sgi_verbatim(px, bpc, dimension))
    got = held(tmp_path, "tex.sgi", data)
    high = (px >> 8 if bpc == 2 else px).astype(np.uint8)
    assert np.array_equal(got[..., :z] if z > 1 else got[..., 0],
                          high if z > 1 else high[..., 0])


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("bpc", [1, 2])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_pil_written_sgi_decodes_as_jax(mode, bpc, size, tmp_path):
    img = (Image.fromarray(pixels(*size, 4, 3)) if mode == "RGBA"
           else pil_image(mode, *size, 3))
    held(tmp_path, "tex.sgi", pil_file(img, "SGI", bpc=bpc))


def _sgi_damage():
    """{case: file}: RLE SGI files damaged where PIL's decoder checks, and
    where it reads on."""
    w, h = 9, 4
    px = sgi_samples(w, h, 3, 1, seed=5)
    base = sgi_rle(px, 1)
    tab = 512

    def entry(data, table, row, value):
        d = bytearray(data)
        struct.pack_into(">I", d, tab + 4 * (table * 3 * h + row), value)
        return bytes(d)

    def with_row(row, packets):
        """``base`` with channel 0's ``row`` (bottom-up) replaced by
        ``packets`` appended at the end of the file."""
        d = entry(base, 0, row, len(base))
        return entry(d, 1, row, len(packets)) + packets

    fill = bytes([0x89]) + bytes(range(1, 10)) + b"\0"
    return {
        "cut-in-tables": base[:tab + 20],
        "cut-in-rows": base[:len(base) - 40],
        "cut-last-byte": base[:-1],
        "verbatim-cut": sgi_verbatim(px, 1, 3)[:-1],
        "start-before-data": entry(base, 0, 1, 100),
        "start-past-end": entry(base, 0, 1, len(base) + 50),
        "start-past-end-length-0": entry(entry(base, 0, 1, len(base) + 50),
                                         1, 1, 0),
        "length-0": entry(base, 1, 2, 0),
        "length-1": entry(base, 1, 2, 1),
        "length-2**31": entry(base, 1, 2, 1 << 31),
        "run-past-the-row": with_row(1, bytes([12, 7, 0])),
        "literal-past-the-row": with_row(1, bytes([0x8c]) + bytes(12) + b"\0"),
        "row-ends-early": with_row(1, bytes([0x83, 1, 2, 3, 0])),
        "row-without-its-end": with_row(1, bytes([0x89]) + bytes(range(9))),
        "literal-to-the-last-byte": with_row(1, fill[:-1]),
        "run-value-is-the-last-byte": with_row(1, bytes([9, 5])),
        "compression-2": base[:2] + b"\2" + base[3:],
        "mode-not-in-pils-table": base[:10] + struct.pack(">H", 2) + base[12:],
        "bpc-3": base[:3] + b"\3" + base[4:],
        "width-0": base[:6] + b"\0\0" + base[8:],
    }


@pytest.mark.parametrize("case", sorted(_sgi_damage()))
def test_damaged_sgi_as_jax(case, tmp_path):
    """None where PIL raises (tables past the file, a start before the
    data, a run or a literal past a row, a read past the file's last
    byte but one, a mode outside PIL's table), PIL's pixels where it reads
    on (a row that ends early keeps the previous row's samples; a row
    whose last packet is not its end stops the decoding, the rows after it
    black; a length of 0, or of 2**31 and more, leaves the row as it
    was)."""
    as_jax(tmp_path, "tex.sgi", _sgi_damage()[case])


# ---- PCX -------------------------------------------------------------------

def _pcx_cases():
    cases = {}
    for w, h in SIZES + [(3, 2), (9, 3)]:
        for mode in ("1", "L", "P", "RGB"):
            if (mode, w) != ("RGB", 1):       # (see the next test)
                cases[f"pil-{mode}-{w}x{h}"] = pil_file(
                    pil_image(mode, w, h, 4), "PCX")
    rng = np.random.default_rng(6)
    pal16 = rng.integers(0, 256, 48, np.uint8).tobytes()
    colour = b"\x0c" + rng.integers(0, 256, 768, np.uint8).tobytes()
    for w, h in [(1, 1), (3, 2), (5, 4), (8, 2), (9, 3), (17, 5), (37, 29)]:
        for bits, planes, version, tails in (
                (1, 1, 2, (b"",)), (1, 1, 5, (b"",)), (1, 2, 5, (b"",)),
                (1, 4, 5, (b"",)), (8, 3, 5, (b"",)),
                (8, 1, 5, (ti.GREY_PCX_PALETTE, colour,
                           b"\x0b" + colour[1:]))):
            natural = (w * bits + 7) // 8
            # the header's stride: PIL's own, even, and one over; where it
            # is not PIL's own, PIL lays the lines out at its own, made even
            for stride in sorted({natural, natural + natural % 2,
                                  natural + 1}):
                pils = natural + (natural % 2 if stride != natural else 0)
                lines = rng.integers(0, 256, (h, planes * pils), np.uint8)
                lines[:, :2] = 0xC5           # a run, and the escape
                for t, tail in enumerate(tails):
                    cases[f"{bits}x{planes}-v{version}-{w}x{h}-stride"
                          f"{stride}-tail{t}"] = ti.pcx_bytes(
                        lines, w, bits, planes, version, stride, pal16, tail)
    lines = rng.integers(0, 256, (4, 3 * 6), np.uint8)
    cases["origin-at-3-2"] = ti.pcx_bytes(lines, 5, 8, 3, origin=(3, 2))
    return cases


PCX_CASES = _pcx_cases()


@pytest.mark.parametrize("case", sorted(PCX_CASES))
def test_pcx_decodes_as_jax(case, tmp_path):
    held(tmp_path, "tex.pcx", PCX_CASES[case])


def test_one_pixel_wide_rgb_pcx_is_none_as_in_jax(tmp_path):
    """PIL's PCX writer drops the blue plane of an RGB image one pixel
    wide (PcxEncode.c), and PIL cannot read its own file back: None in
    both, from PIL's file and from the port's (the same bytes)."""
    px = pixels(1, 6, 3, 12)
    path = tmp_path / "x.pcx"
    image.write_image(str(path), px)
    assert path.read_bytes() == pil_file(Image.fromarray(px), "PCX")
    assert jimage.load_rgba(str(path)) is None
    assert image.load_rgba(str(path)) is None


def test_pcx_with_an_odd_stride_decodes_as_jax(tmp_path):
    """A 5-pixel RGB PCX whose header gives PIL's own stride, 5 (odd): PIL
    keeps it, so each line is 15 bytes and the planes are 5 apart."""
    data = PCX_CASES["8x3-v5-5x4-stride5-tail0"]
    assert struct.unpack_from("<H", data, 66)[0] == 5
    held(tmp_path, "tex.pcx", data)


@pytest.mark.parametrize("mode", ["P;2L", "P;4L"])
def test_pcx_bit_planes_take_the_header_palette(mode, tmp_path):
    """1-bit planes make a colour index (plane k is bit k) into the 16
    colours of the header."""
    planes = int(mode[2])
    w, h = 16, 2
    rng = np.random.default_rng(planes)
    index = rng.integers(0, 1 << planes, (h, w))
    lines = np.concatenate([np.packbits((index >> p) & 1, axis=1)
                            for p in range(planes)], 1).astype(np.uint8)
    pal16 = rng.integers(0, 256, 48, np.uint8).tobytes()
    got = held(tmp_path, "tex.pcx", ti.pcx_bytes(lines, w, 1, planes,
                                                 palette16=pal16))
    lut = np.frombuffer(pal16, np.uint8).reshape(16, 3)
    np.testing.assert_array_equal(got[..., :3], lut[index])


def _pcx_damage():
    rng = np.random.default_rng(8)
    lines = rng.integers(0, 256, (3, 8), np.uint8)
    rgb = ti.pcx_bytes(np.repeat(lines[:, :1], 3 * 8, 1), 8, 8, 3)
    grey = ti.pcx_bytes(lines, 8, 8, 1, tail=ti.GREY_PCX_PALETTE)
    return {
        "cut-in-data": rgb[:-1],
        "cut-after-a-count": rgb[:-1] + b"\xc3",
        "run-across-lines": ti.pcx_bytes(
            np.zeros((3, 24), np.uint8), 8, 8, 3,
            body=bytes([0xC0 | 48, 0, 0xC0 | 24, 0])),
        "run-count-0": ti.pcx_bytes(lines, 8, 8, 1, tail=ti.GREY_PCX_PALETTE,
                                    body=b"\xc0\x07" + b"".join(
                                        ti.pcx_rle(bytes(r)) for r in lines)),
        "8-bit-shorter-than-its-palette": ti.pcx_bytes(lines, 8, 8, 1),
        "bits-2": ti.pcx_bytes(lines, 32, 2, 1),
        "version-0-at-8-bits": grey[:1] + b"\0" + grey[2:],
        "8-bits-2-planes": ti.pcx_bytes(lines, 4, 8, 2),
        "1-bit-3-planes": ti.pcx_bytes(lines[:, :6], 8, 1, 3),
        "empty-box": grey[:8] + b"\0\0" + grey[10:],
    }


@pytest.mark.parametrize("case", sorted(_pcx_damage()))
def test_damaged_pcx_as_jax(case, tmp_path):
    """None where PIL raises: data that ends before the last line, a run
    across a line's end ("buffer overrun"), an 8-bit file too short for
    PIL's ``seek(-769, SEEK_END)``, an unknown mode; a run of count 0
    writes nothing and decodes."""
    as_jax(tmp_path, "tex.pcx", _pcx_damage()[case])


# ---- IM --------------------------------------------------------------------

IM_WRITTEN = ["1", "L", "LA", "P", "PA", "I", "F", "RGB", "RGBA", "RGBX",
              "CMYK", "YCbCr"]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", IM_WRITTEN)
def test_pil_written_im_decodes_as_jax(mode, size, tmp_path):
    """Every mode of PIL's IM writer but the 16-bit grey ones (the named
    deviation, below): ``P`` and ``PA`` are written as Greyscale and LA
    with a ``Lut``."""
    held(tmp_path, "tex.im", pil_file(pil_image(mode, *size, 7), "IM"))


@pytest.mark.parametrize("mode", ["I;16", "I;16L", "I;16B"])
def test_16bit_grey_im_is_the_named_deviation(mode, tmp_path):
    """``L 16``, ``L 16L`` and ``L 16B`` files keep the high byte of each
    sample, as 16-bit grey PNG and TIFF do; PIL clips at 255. Under 256
    both agree."""
    w, h = 11, 6
    rng = np.random.default_rng(9)
    value = rng.integers(0, 1 << 16, (h, w))
    value[0] = np.arange(w) * 25                  # a row under 256
    dt = ">u2" if mode == "I;16B" else "<u2"
    data = pil_file(Image.frombytes(mode, (w, h), value.astype(dt).tobytes()),
                    "IM")
    path = tmp_path / "grey16.im"
    path.write_bytes(data)
    got = image.load_rgba8(str(path))
    np.testing.assert_array_equal(got[..., 0], (value >> 8).astype(np.uint8))
    assert (got[..., :3] == got[..., :1]).all() and (got[..., 3] == 255).all()
    with Image.open(path) as im:
        assert im.mode == mode
        pil = np.asarray(im.convert("RGBA"))
    np.testing.assert_array_equal(pil[..., 0], np.minimum(value, 255))
    assert not np.array_equal(got, pil)


def im_bytes(lines, body: bytes, end: bytes = b"\x1a",
             pad: bool = True) -> bytes:
    """An IM file: ``lines`` (bytes) with CR LF, zeros to byte 511 (or
    none), ``end`` and ``body``."""
    head = b"".join(line + b"\r\n" for line in lines)
    if pad:
        head += bytes(511 - len(head))
    return head + end + body


def _im_cases():
    rng = np.random.default_rng(10)
    w, h = 7, 5
    rgb = rng.integers(0, 256, h * w * 3, np.uint8).tobytes()
    grey = rgb[:h * w]
    size = b"Image size (x*y): 7*5"
    linear = np.tile(np.arange(256, dtype=np.uint8), 3).tobytes()
    ramp = np.tile(rng.integers(0, 256, 256, np.uint8), 3).tobytes()
    colour = rng.integers(0, 256, 768, np.uint8).tobytes()
    cases = {}
    for typ, body in ((b"Greyscale", grey), (b"LA", grey * 2),
                      (b"RGB", rgb)):
        for name, lut in (("linear", linear), ("grey", ramp),
                          ("colour", colour)):
            cases[f"{typ.decode()}-lut-{name}"] = im_bytes(
                [b"Image type: " + typ + b" image", size, b"Lut: 1"],
                lut + body)
    cases.update({
        "B4-with-a-colour-lut": im_bytes(
            [b"Image type: B4 image", size, b"Lut: 1"], colour + grey),
        "PA-with-a-colour-lut": im_bytes(
            [b"Image type: PA image", size, b"Lut: 1"], colour + grey * 2),
        "aliases-0-1-as-L-1": im_bytes(
            [b"Image type: L 1 image", size], bytes(h)),
        "aliases-Grayscale": im_bytes([b"Image type: Grayscale image", size],
                                      grey),
        "aliases-L*32S": im_bytes([b"Image type: L*32S image", size],
                                  grey * 4),
        "no-image-type-is-L": im_bytes([size, b"Name: x"], grey),
        "no-size-is-512x512": im_bytes([b"Image type: Greyscale image"],
                                       bytes(512 * 512)),
        "size-with-a-comma": im_bytes(
            [b"Image type: RGB image", b"Image size (x*y): 7,5"], rgb),
        "size-with-spaces": im_bytes(
            [b"Image type: RGB image", b"Image size (x*y):  7 * 5 "], rgb),
        "comments-and-unknown-keys": im_bytes(
            [b"Comment: one", b"Image type: RGB image", b"Comment: two",
             b"Foo: bar", size, b"Scale (x,y): 1.5,2"], rgb),
        "no-padding": im_bytes([b"Image type: RGB image", size], rgb,
                               pad=False),
        "NUL-then-end": im_bytes([b"Image type: RGB image", size], rgb,
                                 end=b"\0\0\x1a", pad=False),
        "LF-CR-lines": (b"\rImage type: RGB image\n\r" + size + b"\n\x1a"
                        + rgb),
        "second-frame-ignored": im_bytes(
            [b"Image type: RGB image", size,
             b"File size (no of images): 2"], rgb * 2),
    })
    return cases


IM_CASES = _im_cases()


@pytest.mark.parametrize("case", sorted(IM_CASES))
def test_im_decodes_as_jax(case, tmp_path):
    """IM headers as PIL reads them: a ``Lut`` that is not grey makes
    Greyscale ``P`` (and B2/B4, which PIL reads as ``P``, too) and LA
    (and PA) ``PA``, a grey one and any on RGB change nothing; the
    defaults (L, 512x512); CR before a line; NULs before the ``^Z``."""
    held(tmp_path, "tex.im", IM_CASES[case])


def test_ycc_im_holds_pils_tables_for_every_cb_cr(tmp_path):
    """YCbCr to RGB by PIL's fixed-point tables, over every (Cb, Cr) pair
    at Y = 0, 1, 64, 128, 200, 254 and 255 (clipping at both ends
    included)."""
    cb, cr = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    ycc = np.concatenate([np.stack([np.full_like(cb, y), cb, cr], -1)
                          for y in (0, 1, 64, 128, 200, 254, 255)]).astype(
        np.uint8)
    data = pil_file(Image.frombytes("YCbCr", ycc.shape[1::-1],
                                    ycc.tobytes()), "IM")
    held(tmp_path, "ycc.im", data)


def _im_damage():
    rgb = IM_CASES["size-with-a-comma"]
    size = b"Image size (x*y): 7*5"
    body = bytes(7 * 5 * 3)
    return {
        "cut-in-pixels": rgb[:-1],
        "cut-in-lut": IM_CASES["RGB-lut-colour"][:512 + 500],
        "no-end-of-header": im_bytes([b"Image type: RGB image", size], body,
                                     end=b"", pad=False),
        "size-0": im_bytes([b"Image type: RGB image",
                            b"Image size (x*y): 0*5"], body),
        "size-one-number": im_bytes([b"Image type: RGB image",
                                     b"Image size (x*y): 7"], body),
        "size-three-numbers": im_bytes([b"Image type: RGB image",
                                        b"Image size (x*y): 7*5*1"], body),
        "size-a-float": im_bytes([b"Image type: RGB image",
                                  b"Image size (x*y): 7.0*5"], body),
        "scale-not-a-number": im_bytes([b"Image type: RGB image", size,
                                        b"Scale (x,y): big"], body),
        "type-not-pils": im_bytes([b"Image type: Foo image", size], body),
        "type-without-image": im_bytes([b"Image type: RGB", size], body),
        "a-line-over-100-bytes": im_bytes(
            [b"Image type: RGB image", size, b"Comment: " + b"x" * 95],
            body),
        "a-line-without-a-key": im_bytes(
            [b"Image type: RGB image", size, b"nonsense"], body),
    }


@pytest.mark.parametrize("case", sorted(_im_damage()))
def test_damaged_im_as_jax(case, tmp_path):
    as_jax(tmp_path, "tex.im", _im_damage()[case])


REFUSED_IM_TYPES = ["B2", "B4", "RLB", "RYB", "X 24", "RGB3", "RYB3",
                    "L 32 S", "L 32 F", "L 8", "L 8S", "L 16S", "L 32",
                    "L*12", "L*16", "PA"]


@pytest.mark.parametrize("typ", REFUSED_IM_TYPES)
def test_im_types_not_decoded_raise_naming_the_file(typ, tmp_path):
    """The image types PIL opens and its IM writer does not make raise
    ``NotImplementedError`` naming the file (ROADMAP item 11d step 6)."""
    path = tmp_path / "my_texture.im"
    path.write_bytes(im_bytes([f"Image type: {typ} image".encode(),
                               b"Image size (x*y): 8*4"], bytes(8 * 4 * 4)))
    with pytest.raises(NotImplementedError, match="my_texture.im"):
        image.load_rgba(str(path))


# ---- the host library's run-length decoders --------------------------------

def sgi_rows_file(rows, w: int, bpc: int = 1) -> bytes:
    """A one-channel RLE SGI file whose bottom-up rows are the packet
    strings ``rows``, each with its table length (packets PIL may read)."""
    h = len(rows)
    head = (struct.pack(">hBBHHHHll4s79ss", 474, 1, bpc, 2, w, h, 1, 0, 255,
                        b"", b"x", b"") + struct.pack(">l404s", 0, b""))
    sizes = [len(packets) for packets, _ in rows]
    at = 512 + 8 * h + np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return (head + at.astype(">u4").tobytes()
            + np.array([n for _, n in rows], ">u4").tobytes()
            + b"".join(packets for packets, _ in rows))


def _sgi_codec_cases():
    def w16(*words):
        return np.array(words, ">u2").tobytes()

    def rows(*packets):
        return [(p, len(p)) for p in packets]

    return {
        # (rows, width, bpc)
        "longest-run": (rows(bytes([127, 9, 0]), bytes([127, 8, 0])), 127, 1),
        "longest-literal": (rows(*[bytes([0xFF]) + bytes(range(k, k + 127))
                                   + b"\0" for k in (0, 9)]), 127, 1),
        "run-past-the-row": (rows(bytes([3, 1, 0]), bytes([4, 2, 0])), 3, 1),
        "count-byte-at-the-end": ([(bytes([3, 1, 0]), 3),
                                   (bytes([3]), 2)], 3, 1),
        "last-packet-not-the-end": ([(bytes([3, 1, 0]), 3),
                                     (bytes([2, 5, 1, 6, 0]), 2),
                                     (bytes([3, 7, 0]), 3)], 3, 1),
        "runs-16-bit": (rows(*[w16(2, 0x1234, 0x83, 1, 0xFFFF, 2, 0)] * 3),
                        5, 2),
        "runs-16-bit-value-past-the-end": ([(w16(5, 0x0101, 0), 6),
                                            (w16(5) + b"\0", 3)], 5, 2),
    }


@pytest.mark.parametrize("case", sorted(_sgi_codec_cases()))
def test_sgi_rle_codec_as_pil(case):
    """``codecs.sgi_rle`` alone: the longest run and literal (127), a run
    past the row (PIL's overrun), a count byte that is the file's last
    (PIL reads no value after it), a row whose last packet allowed is not
    its end (PIL stops there, the rows after it black), 16-bit runs and
    literals (the count in the low byte of each word), a 16-bit run whose
    value would run past the file; each held to PIL's decode of the same
    file."""
    rows, w, bpc = _sgi_codec_cases()[case]
    data = sgi_rows_file(rows, w, bpc)
    want = ti.pil_rgba8(data)
    try:
        out = codecs.sgi_rle(data, w, len(rows), 1, bpc)
    except codecs.BrokenData:
        assert want is None
        return
    assert want is not None
    got = out.reshape(len(rows), w, bpc)[..., 0][::-1]
    np.testing.assert_array_equal(got, want[..., 0])


def _pcx_codec_cases():
    return {
        # (body, width, lines): RGB, 3 planes of `width` bytes a line
        "longest-run": (bytes([0xFF, 7, 0xFF, 8]), 42, 1),
        "escape-0xc0-and-up": (bytes([0xC1, 0xC0, 0xC1, 0xFF, 0x41, 0xC2,
                                      0xC5, 0x07]), 2, 1),
        "run-of-0": (bytes([0xC0, 9, 1, 2, 0xC0, 3, 4, 5, 6, 7]), 2, 1),
        "run-across-lines": (bytes([0xC8, 5, 0xC4, 6]), 2, 2),
        "count-byte-at-the-end": (bytes([1, 2, 3, 4, 5, 0xC1]), 2, 1),
        "lines-from-one-stream": (bytes([0xC4, 1, 0xC2, 2, 0xC6, 3]), 2, 2),
    }


@pytest.mark.parametrize("case", sorted(_pcx_codec_cases()))
def test_pcx_rle_codec_as_pil(case):
    """``codecs.pcx_rle`` alone on RGB files: the longest run (63), PIL's
    escape of a byte of 0xC0 and up (a run of one), a run of count 0, a
    run across a line's end (PIL's "buffer overrun"), a count byte that is
    the data's last, lines that follow in one stream; each held to PIL's
    decode of the same file."""
    body, w, h = _pcx_codec_cases()[case]
    data = ti.pcx_bytes(np.zeros((h, 3 * w), np.uint8), w, 8, 3, body=body)
    want = ti.pil_rgba8(data)
    try:
        got = codecs.pcx_rle(data[128:], w, 24, 3 * w, h)
    except codecs.BrokenData:
        assert want is None
        return
    assert want is not None
    np.testing.assert_array_equal(
        got.reshape(h, 3, w).transpose(0, 2, 1), want[..., :3])


# ---- what the port writes, read back --------------------------------------

WRITTEN = [(ext, mode, size) for ext in (".dib", ".im", ".sgi", ".bw",
                                         ".rgb", ".rgba", ".pcx")
           for mode in ("L", "RGB")
           for size in ((1, 1), (2, 3), (37, 29), (64, 5))
           if (ext, mode, size[0]) != (".pcx", "RGB", 1)]


@pytest.mark.parametrize("ext,mode,size", WRITTEN,
                         ids=lambda v: v if isinstance(v, str)
                         else f"{v[0]}x{v[1]}")
def test_written_files_load_back(ext, mode, size, tmp_path):
    """``write_image`` then ``load_rgba8``: the written pixels (grey
    broadcast to RGB, alpha 255), and PIL's decode of the same file (an
    RGB PCX one pixel wide, which PIL cannot read back, is held above)."""
    w, h = size
    px = pixels(w, h, 3, 11)
    px = np.ascontiguousarray(px[..., 1]) if mode == "L" else px
    path = tmp_path / f"x{ext}"
    image.write_image(str(path), px)
    got = held(tmp_path, path.name, path.read_bytes())
    want = np.full((h, w, 4), 255, np.uint8)
    want[..., :3] = px[..., None] if mode == "L" else px
    np.testing.assert_array_equal(got, want)


def test_reader_map_digests_are_pils(tmp_path):
    """``tests/torch_data/map_digests.json`` (which ``chip_smoke.py`` holds
    the card machine's maps and decodes to) holds the RLE SGI encoder's
    file, PIL's PCX file, the CMYK and YCbCr TIFF encoder's files, the
    ``icon_digest`` of PIL's ICNS and ICO files, the RLE8 BMP, DIB ICO,
    CUR and ICNS encoders' files (the JP2 entry the port's, PIL's byte
    for byte) and PIL's decode of each;
    the port's decode equals it (and the pixels of the RGB and grey maps,
    where they are read at their own size) and the port's PCX writer writes
    PIL's file (its ICNS and ICO writers PIL's directories and frames)."""
    import hashlib
    import json
    with open(os.path.join(REPO, "tests", "torch_data",
                           "map_digests.json")) as f:
        recorded = json.load(f)
    assert sorted(recorded) == sorted(fx.READER_MAPS)
    from pathtracing_spectrum_tpu_torch.utils import jpeg2000
    for name, want in recorded.items():
        px, data = fx.reader_map(name, lambda px: jpeg2000.encode(px, "jp2"))
        path = tmp_path / name
        if data is None:
            image.write_image(str(path), px)
        else:
            path.write_bytes(data)
        data = path.read_bytes()
        assert fx.file_digest(name, data, image._decode_png) == want[
            "file_sha256"]
        got = held(tmp_path, name, data)
        assert list(got.shape) == want["shape"]
        assert hashlib.sha256(got.tobytes()).hexdigest() == want[
            "rgba_sha256"]
        if px is not None and not name.endswith(fx.ICON_EXTENSIONS):
            rgb = np.repeat(px[..., None], 3, 2) if px.ndim == 2 else px
            np.testing.assert_array_equal(got[..., :3], rgb)


# ---- scenes ----------------------------------------------------------------

def sgi_and_pcx(tmp_path):
    """Paths of a 61x47 RLE SGI (RGB) and a 31x23 PCX (RGB, odd width)."""
    rough = tmp_path / "rough.sgi"
    rough.write_bytes(fx.sgi_rle_bytes(ti.smooth_rgb(16, 61, 47), b"rough"))
    normal = tmp_path / "normal.pcx"
    image.write_image(str(normal), ti.smooth_rgb(17, 31, 23))
    return str(rough), str(normal)


@pytest.mark.parametrize("build_bvh", [False, True])
def test_compile_with_sgi_and_pcx_maps_equals_jax(build_bvh, tmp_path):
    rough, normal = sgi_and_pcx(tmp_path)
    jsc = cornell_scene(depth=2, res=(16, 16),
                        block_types=(MaterialType.GLOSSY, MaterialType.GLOSSY))
    jsc.set_roughness_texture(0, 6, rough)
    jsc.set_roughness_texture(0, 7, rough)
    jsc.set_normal_texture(0, 3, normal)
    got = to_port_scene(jsc).compile("cpu", build_bvh=build_bvh)
    assert got.textures.shape == (2, 47, 61, 4)
    assert_fields_equal(jsc.compile(build_bvh=build_bvh), got)


@pytest.mark.parametrize("dispersion", [False, "hero"])
def test_sgi_and_pcx_mapped_trace_matches_jax_under_one_key(dispersion,
                                                             tmp_path):
    """The glossy wall of ``normal_mapped_wall`` with the RLE SGI
    roughness map and the PCX normal map (rtol 1e-4 / atol 1e-6)."""
    rough, normal = sgi_and_pcx(tmp_path)
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    got, want = trace_both(jsc, jsc.trace_depth, 3, dispersion)
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


_NO_JAX_READERS = r"""
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
rough, normal = os.path.join(tmp, "r.sgi"), os.path.join(tmp, "n.pcx")
px = fx.procedural_rgb(40, 24, 3)
with open(rough, "wb") as f:
    f.write(fx.sgi_rle_bytes(px, b"r"))
image.write_image(normal, px[::-1])
for ext in (".dib", ".im"):
    image.write_image(os.path.join(tmp, "x" + ext), px)
    assert (image.load_rgba8(os.path.join(tmp, "x" + ext))[..., :3] == px).all()
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


def test_sgi_and_pcx_mapped_render_imports_neither_jax_nor_pil(tmp_path):
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_READERS, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
