"""The port's QOI and DDS readers and its QOI, DDS, EPS/PS and MPO writers
against the JAX package (PIL 12.1): ``load_rgba`` bit for bit as an
int32 view (tolerance 0), None where it is None, and ``write_image``
byte for byte as ``PIL.Image.save``.

- QOI, reading: PIL's files of RGB and RGBA at 1x1 to 64x64 (flat,
  smooth and noise content, runs past 62), hand-made streams for each op
  and each way PIL's Python decoder is not qoi.h (an index slot never
  filled reads as transparent black and is then stored at slot 0, a run
  is not stored in the index, a run may pass the last pixel, the end
  marker is never read, the colorspace byte is ignored, a channels byte
  other than 3 is RGBA), seeded random op streams, and data that ends
  inside an op (None in both).
- QOI, writing: PIL's QoiEncoder byte for byte at up to 256x256 (PIL's
  encoder is Python), runs cut at 62, deltas that wrap as signed chars;
  L raises PIL's ``ValueError``.
- DDS: every file PIL's writer makes (raw L, LA, RGB and RGBA, and DXT1,
  DXT3, DXT5, BC2, BC3, BC5); hand-made RGB and RGBA headers at 0 to 64
  bits with 565, 4444, padded, holed and zero masks, a file cut inside
  its pixels (PIL reads zeros there); LA, P with an RGBA palette, DX10
  RGBA8 under its three names; BC1-BC5 under every fourcc and DXGI name
  PIL reads, with seeded random blocks; BC6H and BC7 read as the JAX
  package reads them (``tests/test_torch_bc7_bc6h.py`` holds them in
  full); what PIL refuses None.
- EPS (``.eps``, ``.ps``) and single-frame MPO byte for byte in L and
  RGB; the MPO read back as the JPEG decoder reads it.
- A scene with a QOI roughness map and a DXT1 normal map compiled and
  traced under one key against the JAX package (rtol 1e-4 / atol 1e-6, as
  ``tests/test_torch_spectral.py`` states it), and a render from those
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
from pathtracing_spectrum_tpu_torch import _build  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import codecs, image  # noqa: E402

import torch_images as ti  # noqa: E402
from scene_helpers import cornell_scene  # noqa: E402
from test_torch_readers import as_jax, held, pil_file  # noqa: E402
from test_torch_scene import assert_fields_equal, to_port_scene  # noqa: E402,E501
from test_torch_spectral import assert_same, trace_both  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_torch_fixtures", os.path.join(REPO, "tools",
                                        "make_torch_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

SIZES = [(1, 1), (37, 29), (64, 64)]           # (W, H)


def content(kind: str, w: int, h: int, bands: int, seed: int) -> np.ndarray:
    """[h, w, bands] uint8: ``flat`` (one colour: runs past 62),
    ``smooth`` (small steps: QOI_OP_DIFF and QOI_OP_LUMA) or ``noise``."""
    rng = np.random.default_rng(seed)
    if kind == "flat":
        return np.full((h, w, bands), 77, np.uint8)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, bands), np.uint8)
    px = ti.smooth_rgb(seed, w, h, noise=6)
    if bands == 4:
        alpha = np.full((h, w, 1), 255, np.uint8)
        alpha[h // 2:] = rng.integers(0, 4, (h - h // 2, w, 1)) * 80
        px = np.concatenate([px, alpha], -1)
    return px


def qoi(width: int, height: int, ops: bytes, channels: int = 4,
        colorspace: int = 0, end: bool = True) -> bytes:
    return (b"qoif" + struct.pack(">II", width, height)
            + bytes((channels, colorspace)) + ops
            + (bytes((0,) * 7 + (1,)) if end else b""))


# ---- QOI, reading ----------------------------------------------------------

@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["flat", "smooth", "noise"])
@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_pil_written_qoi_decodes_as_jax(mode, kind, size, tmp_path):
    w, h = size
    px = content(kind, w, h, len(mode), w * h + len(kind))
    got = held(tmp_path, "x.qoi", pil_file(Image.fromarray(px, mode), "QOI"))
    assert np.array_equal(got[..., :len(mode)], px)


RGBA_7 = bytes((0xFF, 10, 20, 30, 7))       # QOI_OP_RGBA (10, 20, 30, 7)
QOI_STREAMS = {
    # the run of the start pixel is not stored: slot 53 (its hash) is empty
    "run-not-stored": (2, 1, bytes((0xC0, 53))),
    # an empty slot reads as (0, 0, 0, 0), which is then stored at slot 0
    "empty-slot-then-slot-0": (3, 1, bytes((17, 0xFE, 1, 2, 3, 0))),
    "filled-slot": (3, 1, RGBA_7 + bytes((0xFE, 9, 9, 9))
                    + bytes(((10 * 3 + 20 * 5 + 30 * 7 + 7 * 11) % 64,))),
    "diff-wraps": (3, 1, bytes((0x40, 0x7F, 0x55))),
    "luma-wraps": (3, 1, bytes((0x80, 0x00, 0xBF, 0xFF, 0x9F, 0x88))),
    "rgb-keeps-alpha": (2, 1, RGBA_7 + bytes((0xFE, 200, 100, 50))),
    "run-past-the-end": (3, 2, bytes((0xFE, 5, 6, 7, 0xFD))),
    "run-of-62-then-index": (64, 1, bytes((0xFE, 5, 6, 7, 0xFD, 0xC0, 0))),
    "every-op": (4, 2, RGBA_7 + bytes((0x6A, 0xA3, 0x5F, 0xC1,
                                       0xFE, 1, 2, 3, 0x05))),
}


@pytest.mark.parametrize("channels", [3, 4, 7])
@pytest.mark.parametrize("case", sorted(QOI_STREAMS))
def test_hand_made_qoi_streams_decode_as_jax(case, channels, tmp_path):
    """Each op and each of PIL's quirks, under channels 3 (RGB: alpha
    tracked, dropped), 4 and 7 (any byte but 3 is RGBA)."""
    w, h, ops = QOI_STREAMS[case]
    held(tmp_path, "x.qoi", qoi(w, h, ops, channels))


def test_run_not_stored_is_pils_not_qoi_h(tmp_path):
    """A run of the start pixel, then QOI_OP_INDEX of its hash: PIL gives
    transparent black for the second pixel, qoi.h (0, 0, 0, 255)."""
    got = held(tmp_path, "x.qoi", qoi(2, 1, bytes((0xC0, 53)), 4))
    assert got.tolist() == [[[0, 0, 0, 255], [0, 0, 0, 0]]]


@pytest.mark.parametrize("case", ["no-end-marker", "colorspace-9",
                                  "trailing-junk"])
def test_qoi_end_marker_and_colorspace_are_not_read(case, tmp_path):
    ops = bytes((0xFE, 1, 2, 3, 0x41, 0xC2))
    data = {"no-end-marker": qoi(4, 1, ops, end=False),
            "colorspace-9": qoi(4, 1, ops, colorspace=9),
            "trailing-junk": qoi(4, 1, ops) + b"junk" * 9}[case]
    held(tmp_path, "x.qoi", data)


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("channels", [3, 4])
def test_random_qoi_op_streams_decode_as_jax(channels, seed, tmp_path):
    """Seeded random op bytes (every op, runs past the end, slots filled
    or not): the same pixels, or None in both where the data runs out."""
    rng = np.random.default_rng(seed)
    w, h = (int(v) for v in rng.integers(1, 24, 2))
    ops = rng.integers(0, 256, int(rng.integers(8, 3 * w * h + 8)),
                       np.uint8).tobytes()
    as_jax(tmp_path, "x.qoi", qoi(w, h, ops, channels, end=False))


QOI_NONE = {
    "ends-in-op": qoi(3, 1, bytes((0xFE, 1, 2, 3, 0xFE, 1)), end=False),
    "ends-before-pixels": qoi(3, 1, bytes((0xFE, 1, 2, 3)), end=False),
    "ends-in-luma": qoi(2, 1, bytes((0x41, 0x80)), end=False),
    "ends-in-rgba": qoi(1, 1, bytes((0xFF, 1, 2, 3)), end=False),
    "no-ops": qoi(1, 1, b"", end=False),
    "zero-width": qoi(0, 5, bytes((0xC0,))),
    "short-header": b"qoif" + struct.pack(">II", 1, 1),
    "bomb": qoi(20000, 10000, bytes((0xFD,))),
}


@pytest.mark.parametrize("case", sorted(QOI_NONE))
def test_qoi_pil_refuses_is_none_as_in_jax(case, tmp_path):
    path = tmp_path / "x.qoi"
    path.write_bytes(QOI_NONE[case])
    assert jimage.load_rgba(str(path)) is None
    assert image.load_rgba(str(path)) is None


def test_qoi_decoder_alone_matches_pils_raw_pixels():
    px = content("noise", 23, 19, 4, 3)
    data = pil_file(Image.fromarray(px, "RGBA"), "QOI")
    assert np.array_equal(codecs.qoi(data[14:], 23, 19, 4), px)
    with pytest.raises(codecs.BrokenData):
        codecs.qoi(data[14:40], 23, 19, 4)


# ---- QOI, writing ----------------------------------------------------------

def qoi_image(kind: str, w: int, h: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "runs":               # runs of 1 to 200 pixels across rows
        lengths = rng.integers(1, 200, w * h)
        colours = rng.integers(0, 4, (w * h, 3)) * 60
        return np.repeat(colours, lengths, 0)[:w * h].reshape(
            h, w, 3).astype(np.uint8)
    if kind == "wrapping":           # steps near +-128: deltas that wrap
        steps = rng.choice([-129, -128, -127, -33, -32, -9, -8, -3, -2, 1, 2,
                            7, 8, 31, 32, 127, 128, 129], (h, w, 3))
        steps[..., 0] += steps[..., 1]
        steps[..., 2] += steps[..., 1]
        return (np.cumsum(steps.reshape(-1, 3), 0) % 256).reshape(
            h, w, 3).astype(np.uint8)
    if kind == "palette":            # few colours: QOI_OP_INDEX
        return (rng.integers(0, 6, (h, w, 1)) * [40, 25, 17]).astype(np.uint8)
    return content(kind, w, h, 3, seed)


@pytest.mark.parametrize("size", [(1, 1), (37, 29), (64, 64), (256, 7),
                                  (200, 200)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["flat", "smooth", "noise", "runs",
                                  "wrapping", "palette"])
def test_qoi_writer_is_pils_byte_for_byte(kind, size, tmp_path):
    w, h = size
    px = qoi_image(kind, w, h, w + h)
    path = tmp_path / "x.qoi"
    image.write_image(str(path), px)
    assert path.read_bytes() == pil_file(Image.fromarray(px), "QOI")
    assert np.array_equal(image.load_rgba8(str(path))[..., :3], px)


def test_qoi_writer_refuses_l_as_pil(tmp_path):
    path = tmp_path / "x.qoi"
    with pytest.raises(ValueError) as pil_error:
        Image.fromarray(np.zeros((3, 4), np.uint8)).save(io.BytesIO(), "QOI")
    with pytest.raises(ValueError) as port_error:
        image.write_image(str(path), np.zeros((3, 4), np.uint8))
    assert str(port_error.value) == str(pil_error.value)
    assert not path.exists()


# ---- DDS -------------------------------------------------------------------

# every (mode, pixel_format) PIL 12.1's DDS writer takes
DDS_WRITTEN = [(m, pf) for m in ("L", "LA", "RGB", "RGBA")
               for pf in (None, "DXT1", "DXT3", "DXT5", "BC2", "BC3")] + [
    ("RGB", "BC5")]


@pytest.mark.parametrize("size", [(1, 1), (5, 7), (37, 29)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode,pixel_format", DDS_WRITTEN,
                         ids=[f"{m}-{p}" for m, p in DDS_WRITTEN])
def test_pil_written_dds_decodes_as_jax(mode, pixel_format, size, tmp_path):
    w, h = size
    px = content("smooth", w, h, 4, w * h)
    save = {"pixel_format": pixel_format} if pixel_format else {}
    held(tmp_path, "x.dds", pil_file(Image.fromarray(px, "RGBA").convert(
        mode), "DDS", **save))


RGB, RGBA, LUM, PAL, FOURCC = 0x40, 0x41, 0x20000, 0x20, 0x4
MASKED = {
    "rgb565": (16, RGB, (0xF800, 0x7E0, 0x1F, 0)),
    "argb4444": (16, RGBA, (0xF00, 0xF0, 0xF, 0xF000)),
    "argb1555": (16, RGBA, (0x7C00, 0x3E0, 0x1F, 0x8000)),
    "padded-2-bit": (8, RGB, (0b11, 0b1100, 0b110000, 0)),
    "bgr24": (24, RGB, (0xFF, 0xFF00, 0xFF0000, 0)),
    "xrgb32": (32, RGB, (0xFF0000, 0xFF00, 0xFF, 0)),
    "abgr32": (32, RGBA, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    "a2r10g10b10": (32, RGBA, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000)),
    "holed-mask": (16, RGB, (0b1010_0000_0000_0101, 0x7E0, 0, 0)),
    "zero-mask": (24, RGBA, (0xFF0000, 0, 0xFF, 0)),
    "bits-12": (12, RGB, (0xF00, 0xF0, 0xF, 0)),
    "bits-64": (64, RGBA, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    "bits-4": (4, RGB, (0xF, 0xF, 0xF, 0)),
}


@pytest.mark.parametrize("size", [(1, 1), (7, 5), (16, 9)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", sorted(MASKED))
def test_masked_dds_decodes_as_jax(case, size, tmp_path):
    """DdsRgbDecoder's rule, ``int(v / mask * 255)`` in float64, at each
    bit count and mask layout."""
    bits, flags, masks = MASKED[case]
    w, h = size
    body = np.random.default_rng(w + len(case)).integers(
        0, 256, w * h * max(bits // 8, 1), np.uint8).tobytes()
    held(tmp_path, "x.dds", fx.dds_header(w, h, flags, b"", bits, masks)
         + body)


@pytest.mark.parametrize("cut", [1, 5, 30, 60])
def test_masked_dds_cut_short_reads_zeros_as_pil(cut, tmp_path):
    """PIL's decoder reads past the end as zeros (``int.from_bytes`` of an
    empty or short read): no error, black where the data is missing."""
    body = bytes(range(1, 61))
    held(tmp_path, "x.dds", fx.dds_header(5, 4, RGBA, b"", 24,
                                          (0xFF0000, 0xFF00, 0xFF, 0x3))
         + body[:cut])


def dds_uncompressed(case: str, w: int, h: int) -> bytes:
    rng = np.random.default_rng(w * h + len(case))
    if case == "L":
        return fx.dds_header(w, h, LUM, b"", 8) + rng.bytes(w * h)
    if case == "LA":
        return fx.dds_header(w, h, LUM | 1, b"", 16) + rng.bytes(2 * w * h)
    if case == "P":
        return fx.dds_header(w, h, PAL, b"", 8) + rng.bytes(1024 + w * h)
    dxgi = {"RGBA8-typeless": 27, "RGBA8-unorm": 28, "RGBA8-srgb": 29}[case]
    return fx.dds_header(w, h, FOURCC, b"DX10", dxgi=dxgi) + rng.bytes(
        4 * w * h + 3)


@pytest.mark.parametrize("size", [(1, 1), (6, 5), (33, 17)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", ["L", "LA", "P", "RGBA8-typeless",
                                  "RGBA8-unorm", "RGBA8-srgb"])
def test_uncompressed_dds_decodes_as_jax(case, size, tmp_path):
    held(tmp_path, "x.dds", dds_uncompressed(case, *size))


# (fourcc, DXGI format or None, BcnDecode.c's n)
BLOCKS = {"DXT1": (b"DXT1", None, 1), "DXT3": (b"DXT3", None, 2),
          "DXT5": (b"DXT5", None, 3), "BC4U": (b"BC4U", None, 4),
          "ATI1": (b"ATI1", None, 4), "BC5U": (b"BC5U", None, 5),
          "ATI2": (b"ATI2", None, 5), "BC5S": (b"BC5S", None, 5),
          **{f"DX10-{dxgi}": (b"DX10", dxgi, n) for dxgi, n in (
              (70, 1), (71, 1), (73, 2), (74, 2), (76, 3), (77, 3),
              (79, 4), (80, 4), (82, 5), (83, 5), (84, 5))}}


def dds_blocks(case: str, w: int, h: int, seed: int) -> bytes:
    fourcc, dxgi, n = BLOCKS[case]
    nblocks = -(-w // 4) * -(-h // 4)
    payload = np.random.default_rng(seed).integers(
        0, 256, nblocks * (8 if n in (1, 4) else 16), np.uint8).tobytes()
    return fx.dds_header(w, h, FOURCC, fourcc, dxgi=dxgi) + payload


@pytest.mark.parametrize("size", [(1, 1), (5, 7), (13, 6), (16, 16)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_random_dds_blocks_decode_as_jax(case, size, tmp_path):
    """Seeded random blocks: both BC1 colour modes, both BC3 alpha modes,
    BC5S's signed end points; blocks cut at the right and bottom edges."""
    held(tmp_path, "x.dds", dds_blocks(case, *size, seed=len(case) + size[0]))


@pytest.mark.parametrize("dxgi,flavour", [(95, "BC6H"), (96, "BC6HS"),
                                          (97, "BC7"), (98, "BC7"),
                                          (99, "BC7")])
def test_bc6h_and_bc7_dds_are_refused_naming_the_file(dxgi, flavour,
                                                      tmp_path):
    """PIL decodes them (its BC6H and BC7 decoders), and so does the port,
    as the JAX package does: zero blocks (BC7's reserved mode, BC6H's mode
    0 at zero) and hashed ones under the flavour's modes
    (``tests/test_torch_bc7_bc6h.py`` holds every mode)."""
    blocks = (fx.bc7_blocks(4, dxgi) if flavour == "BC7" else
              fx.bc6h_blocks(4, dxgi, signed=flavour == "BC6HS"))
    for payload in (bytes(64), blocks.tobytes()):
        got = held(tmp_path, "my_map.dds", fx.dds_header(
            8, 8, FOURCC, b"DX10", dxgi=dxgi) + payload)
        assert got.shape == (8, 8, 4)


DDS_NONE = {
    "header-size": b"DDS " + struct.pack("<I", 128) + fx.dds_header(
        2, 2, RGB, b"", 24, (0xFF, 0xFF00, 0xFF0000, 0))[8:] + bytes(12),
    "short-header": fx.dds_header(2, 2, RGB, b"", 24)[:100],
    "unknown-fourcc": fx.dds_header(4, 4, FOURCC, b"BC4S") + bytes(8),
    "unknown-dxgi": fx.dds_header(4, 4, FOURCC, b"DX10", dxgi=72)
    + bytes(8),
    "no-flags": fx.dds_header(4, 4, 0, b"DXT1") + bytes(8),
    "luminance-16-no-alpha": fx.dds_header(2, 2, LUM, b"", 16) + bytes(8),
    "luminance-24": fx.dds_header(2, 2, LUM | 1, b"", 24) + bytes(12),
    "blocks-cut": fx.dds_header(8, 4, FOURCC, b"DXT5") + bytes(31),
    "dx10-cut": fx.dds_header(4, 4, FOURCC, b"DX10", dxgi=71)[:140],
    "l-cut": fx.dds_header(4, 4, LUM, b"", 8) + bytes(15),
    "palette-cut": fx.dds_header(2, 2, PAL, b"", 8) + bytes(1000),
    "zero-height": fx.dds_header(4, 0, RGB, b"", 24) + bytes(8),
    "bomb": fx.dds_header(30000, 30000, FOURCC, b"DXT1") + bytes(8),
}


@pytest.mark.parametrize("case", sorted(DDS_NONE))
def test_dds_pil_refuses_is_none_as_in_jax(case, tmp_path):
    path = tmp_path / "x.dds"
    path.write_bytes(DDS_NONE[case])
    assert jimage.load_rgba(str(path)) is None
    assert image.load_rgba(str(path)) is None


def test_bcn_decoder_alone_matches_pils_raw_pixels():
    """BC5S's blue is 128 and BC5's 0 (PIL fills the block before it
    decodes it); BC4 is one byte a pixel."""
    for case, want_blue in (("BC5S", 128), ("BC5U", 0)):
        data = dds_blocks(case, 9, 6, 4)
        with Image.open(io.BytesIO(data)) as im:
            pil = np.asarray(im)
        got = codecs.bcn(data[128:], 5, 9, 6, case == "BC5S")
        assert np.array_equal(got[..., :3], pil)
        assert (got[..., 2] == want_blue).all()
    data = dds_blocks("BC4U", 9, 6, 5)
    with Image.open(io.BytesIO(data)) as im:
        assert np.array_equal(codecs.bcn(data[128:], 4, 9, 6),
                              np.asarray(im))
    with pytest.raises(codecs.BrokenData):
        codecs.bcn(data[128:-1], 4, 9, 6)


@pytest.mark.parametrize("size", [(1, 1), (37, 29), (64, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_dds_writer_is_pils_and_reads_back(mode, size, tmp_path):
    w, h = size
    px = content("noise", w, h, 3, w + h)
    px = np.ascontiguousarray(px[..., 1]) if mode == "L" else px
    path = tmp_path / "x.dds"
    image.write_image(str(path), px)
    assert path.read_bytes() == pil_file(Image.fromarray(px), "DDS")
    rgba = held(tmp_path, "back.dds", path.read_bytes())
    assert np.array_equal(rgba[..., :3], np.repeat(px[..., None], 3, -1)
                          if mode == "L" else px)


# ---- EPS, PS and MPO -------------------------------------------------------

@pytest.mark.parametrize("size", [(1, 1), (13, 3), (39, 2), (40, 5),
                                  (37, 29), (80, 3)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("ext", [".eps", ".ps", ".mpo"])
def test_eps_ps_and_mpo_writers_are_pils_byte_for_byte(ext, mode, size,
                                                        tmp_path):
    """EPS: its hex rows wrap after every 39 bytes, the count running on
    across rows; ``.ps`` writes the same bytes. MPO: one frame is PIL's
    JPEG."""
    w, h = size
    px = content("smooth", w, h, 3, w * h + 1)
    px = np.ascontiguousarray(px[..., 0]) if mode == "L" else px
    path = tmp_path / f"x{ext}"
    image.write_image(str(path), px)
    pil_path = tmp_path / f"pil{ext}"
    Image.fromarray(px).save(pil_path)
    assert path.read_bytes() == pil_path.read_bytes()


def test_eps_keeps_pils_literal_percent_signs(tmp_path):
    path = tmp_path / "x.eps"
    image.write_image(str(path), np.zeros((2, 3), np.uint8))
    data = path.read_bytes()
    assert b"\n%ImageData: 3 2 " in data and b"\n%%BoundingBox: 0 0 3 2\n" \
        in data and data.endswith(b"\n%%%%EndBinary\ngrestore end\n")


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_mpo_reads_back_as_its_jpeg(mode, tmp_path):
    px = content("smooth", 40, 24, 3, 6)
    px = np.ascontiguousarray(px[..., 2]) if mode == "L" else px
    mpo, jpg = tmp_path / "x.mpo", tmp_path / "x.jpg"
    image.write_image(str(mpo), px)
    image.write_image(str(jpg), px)
    got = held(tmp_path, "back.mpo", mpo.read_bytes())
    assert np.array_equal(got, image.load_rgba8(str(jpg)))


# ---- the host library ------------------------------------------------------

def test_qoi_and_dds_have_no_python_fallback(monkeypatch, tmp_path):
    """Where the host library cannot be built, decoding raises the build's
    error (a texture is never dropped as None)."""
    def broken():
        raise RuntimeError("build failed")
    monkeypatch.setattr(_build, "load_host", broken)
    for name, data in (("x.qoi", qoi(1, 1, bytes((0xFE, 1, 2, 3)))),
                       ("x.dds", dds_blocks("DXT1", 4, 4, 1))):
        path = tmp_path / name
        path.write_bytes(data)
        with pytest.raises(RuntimeError, match="build failed"):
            image.load_rgba(str(path))
    with pytest.raises(RuntimeError, match="build failed"):
        image.write_image(str(tmp_path / "x.qoi"), np.zeros((2, 2, 3),
                                                            np.uint8))


# ---- scenes ----------------------------------------------------------------

def qoi_and_dxt1_maps(tmp_path):
    """Paths of a 64x48 QOI roughness map (the port's writer) and a 48x32
    DXT1 normal map of hashed blocks (the fixture tool's)."""
    rough = tmp_path / "rough.qoi"
    image.write_image(str(rough), fx.procedural_rgb(64, 48, 5))
    normal = tmp_path / "normal.dds"
    blocks = fx.dxt1_map_bytes(32, 7)[128:]
    normal.write_bytes(fx.dds_header(48, 32, FOURCC, b"DXT1")
                       + blocks + blocks[:len(blocks) // 2])
    return str(rough), str(normal)


def test_map_files_are_what_pil_reads(tmp_path):
    for path in qoi_and_dxt1_maps(tmp_path):
        with open(path, "rb") as f:
            held(tmp_path, "x" + os.path.splitext(path)[1], f.read())
    held(tmp_path, "map.dds", fx.dxt1_map_bytes(64, 19))


@pytest.mark.parametrize("build_bvh", [False, True])
def test_compile_with_qoi_and_dds_maps_equals_jax(build_bvh, tmp_path):
    rough, normal = qoi_and_dxt1_maps(tmp_path)
    jsc = cornell_scene(depth=2, res=(16, 16),
                        block_types=(MaterialType.GLOSSY, MaterialType.GLOSSY))
    jsc.set_roughness_texture(0, 6, rough)
    jsc.set_roughness_texture(0, 7, rough)
    jsc.set_normal_texture(0, 3, normal)
    got = to_port_scene(jsc).compile("cpu", build_bvh=build_bvh)
    assert got.textures.shape == (2, 48, 64, 4)
    assert_fields_equal(jsc.compile(build_bvh=build_bvh), got)


@pytest.mark.parametrize("dispersion", [False, "hero"])
def test_qoi_and_dds_mapped_trace_matches_jax_under_one_key(dispersion,
                                                            tmp_path):
    """The glossy wall of ``normal_mapped_wall`` with the QOI roughness map
    and the DXT1 normal map (rtol 1e-4 / atol 1e-6)."""
    rough, normal = qoi_and_dxt1_maps(tmp_path)
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    got, want = trace_both(jsc, jsc.trace_depth, 3, dispersion)
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


_NO_JAX_QOI_DDS = r"""
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
data_dir = os.path.join(sys.argv[1], "tests", "torch_data")
rough = os.path.join(tmp, "r.qoi")
image.write_image(rough, fx.procedural_rgb(40, 24, 3))
normal = os.path.join(tmp, "n.dds")
with open(normal, "wb") as f:
    f.write(fx.dxt1_map_bytes(32, 4))
for ext in (".dds", ".eps", ".ps", ".mpo"):
    image.write_image(os.path.join(tmp, "w" + ext),
                      fx.procedural_rgb(9, 7, 1))
for name in ("small.qoi", "small_dxt5.dds", "small_rgba.dds"):
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
assert tuple(data.textures.shape) == (2, 32, 40, 4), data.textures.shape
img = pt.RenderSession(sc, "cpu", seed=1).run(2, batch=2)
assert img.shape == (8, 12, 4) and np.isfinite(img).all() and img.mean() > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "PIL"))
assert not bad, bad
print("ok")
"""


def test_qoi_and_dds_mapped_render_imports_neither_jax_nor_pil(tmp_path):
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_QOI_DDS, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
