"""The X11 and Sun workstation bitmaps the port reads in
``utils/bitmaps.py`` (Sun raster, GIMP brush, Windows Paint MSP, X11
bitmap XBM and X11 pixmap XPM) against the JAX package (PIL): the port's
``load_rgba`` bit for bit as an int32 view of the float32 and its
``load_rgba8`` as uint8 (tolerance 0), None where it is None, apart from
the mapped trace's rtol 1e-4 / atol 1e-6, as
``tests/test_torch_spectral.py`` states it.

- SUN: every depth under types 1, 2 (run-length) and 3 at an odd width;
  planar colour maps at depths 4 and 8 (indices past the map, maps of 4
  and 1 bytes, 768 and 770); the bytes the last raw row needs (and the
  file of 4 that GBR's plugin takes first); run-length records across
  row ends, ``80 00``, cut records, random streams.
- GBR versions 1 and 2 at both depths, a version 2 header of 24 bytes.
- MSP: PIL's ``DanM`` files, ``LinS`` rows of length 0, of the wrong
  length, literals past a row's end, cut runs, rows and row maps.
- XBM: PIL's files with a hotspot, single-digit values, an ``x`` in a
  comment, X10 16-bit values, ``_bits[]`` twice and past 512 bytes.
- XPM: ``P`` and ``RGB``, 1- and 2-character keys, ``#RGB`` and 48-bit
  colours, a colour name, a used and an unused ``None``, a colour line
  without its comma, pixel lines joined, split and commented.
- Where a plugin's open fails: the next plugin PIL tries (a TGA after a
  GBR prefix, GBR before a narrow Sun raster, none for the rest,
  including a C header that starts ``#define``) or None in both.
- The committed fixtures and the card's bitmap maps against their
  recorded digests, the builders against PIL's writers, a ``"hier"``
  trace with a run-length SUN roughness map and an RGB XPM normal map
  against the JAX package's dense one, and a render from such maps in a
  process that refuses to import jax and PIL.

``tools/bitmap_sweep.py`` is the wide sweep: random headers, streams and
texts of each kind, their cuts and flips.
"""

import hashlib
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
from pathtracing_spectrum_tpu_torch.utils import bitmaps, image  # noqa: E402

from PIL import Image  # noqa: E402

from test_torch_readers import as_jax, held, pil_file  # noqa: E402
from test_torch_scene import to_port_scene  # noqa: E402
from test_torch_spectral import assert_same  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402
from test_torch_qoi_dds import REPO, fx  # noqa: E402

DATA = os.path.join(REPO, "tests", "torch_data")
RGB = np.random.default_rng(28).integers(0, 256, (5, 11, 3), np.uint8)


def none_in_both(tmp_path, data: bytes, named) -> None:
    """PIL's open names ``named`` (None: no plugin) and both packages give
    None."""
    assert image._sniff(data) == named
    as_jax(tmp_path, "x.bin", data)
    assert image.load_rgba(str(tmp_path / "x.bin")) is None


# ---- the state machine of the run-length and XBM streams -------------------

@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 300, 5000])
def test_machine_states_are_the_serial_walk(n):
    """``_machine_states`` (chunks run from all three states, then joined)
    is the state of a walk over the bytes one by one, for random tables."""
    r = np.random.default_rng(n)
    for classes in (2, 3):
        table = r.integers(0, 3, (3, classes)).astype(np.uint8)
        cls = r.integers(0, classes, n).astype(np.uint8)
        want, s = np.zeros(n, np.uint8), 0
        for i, c in enumerate(cls):
            want[i] = s
            s = table[s, c]
        np.testing.assert_array_equal(bitmaps._machine_states(cls, table),
                                      want)


# ---- SUN --------------------------------------------------------------------

def sun_samples(depth: int) -> np.ndarray:
    """Samples of the 11x5 image at ``depth`` (bits, nibbles, bytes with
    runs and 0x80 bytes, RGB)."""
    if depth == 1:
        return RGB[..., 0] & 1
    if depth == 4:
        return RGB[..., 0] >> 4
    if depth == 8:
        grey = np.repeat(RGB[:, ::4, 1], 4, 1)[:, :11]
        grey[1, 3:] = 0x80
        return grey
    return RGB


@pytest.mark.parametrize("kind", [1, 2, 3], ids=["raw", "rle", "rgb"])
@pytest.mark.parametrize("depth", [1, 4, 8, 24, 32])
def test_sun_depths_and_types_decode_as_jax(depth, kind, tmp_path):
    """Depth 1 inverted (a set bit black), 4 as 17 v, 8 as grey, 24 and 32
    as BGR (BGRX) or, type 3, RGB (RGBX); raw rows padded to 16 bits at
    the odd width 11, run-length rows unpadded."""
    px = sun_samples(depth)
    got = held(tmp_path, "x.ras", fx.sun_bytes(px, depth, kind))
    if depth == 1:
        np.testing.assert_array_equal(got[..., 0], 255 - 255 * px)
    elif depth == 4:
        np.testing.assert_array_equal(got[..., 0], 17 * px)
    elif depth == 8:
        np.testing.assert_array_equal(got[..., 0], px)
    else:
        np.testing.assert_array_equal(got[..., :3], RGB)


@pytest.mark.parametrize("length", [48, 6, 4, 1, 768, 770])
@pytest.mark.parametrize("depth", [4, 8])
def test_sun_colour_maps_are_planar_as_in_jax(depth, length, tmp_path):
    """PIL's ``RGB;L`` map: entry i is (map[i], map[i + n], map[i + 2n])
    for n = length // 3 entries, indices past them black; 4 bytes are one
    entry of their first three, 1 byte none."""
    colours = fx.hashed_bytes(length, length).tobytes()
    px = RGB[..., 2] % (16 if depth == 4 else 40)
    got = held(tmp_path, "x.ras", fx.sun_bytes(px, depth, 1, colours))
    n = length // 3
    lut = np.zeros((256, 3), np.uint8)
    lut[:n] = np.frombuffer(colours, np.uint8, 3 * n).reshape(3, n).T
    np.testing.assert_array_equal(got[..., :3], lut[px])


# (depth, width, height, data bytes, the format PIL opens it as)
LAST_ROW = {"24-bit 1x2, 7 bytes": (24, 1, 2, 7, "SUN"),
            "24-bit 1x2, 6 bytes": (24, 1, 2, 6, "SUN"),
            "32-bit 1x2, 8 bytes": (32, 1, 2, 8, "SUN"),
            "32-bit 1x2, 7 bytes": (32, 1, 2, 7, "SUN"),
            "32-bit 1x1, 5 bytes": (32, 1, 1, 5, "SUN"),
            "32-bit 1x1, 4 bytes": (32, 1, 1, 4, "GBR"),
            "24-bit 1x1, 4 bytes": (24, 1, 1, 4, "GBR"),
            "8-bit 3x2, 6 bytes": (8, 3, 2, 6, "SUN"),
            "8-bit 3x2, 5 bytes": (8, 3, 2, 5, "SUN")}


@pytest.mark.parametrize("case", list(LAST_ROW))
def test_sun_last_raw_row_needs_its_own_bytes(case, tmp_path):
    """Rows lie 16-bit strides apart, and PIL's raw decoder needs the last
    row's bytes but not its padding: a 24-bit 1x2 file reads with 7 data
    bytes. A 1-pixel-wide file whose header's length field is 1 or 4 is
    GBR's first (its ``_accept`` and header checks pass on a Sun header:
    version = the width, depth = the length field), whose open reads the
    rest as its comment: None, as in PIL, where a 32-bit 1x1 file of 4
    bytes looks like a rule of the raw decoder."""
    depth, w, h, n, named = LAST_ROW[case]
    data = struct.pack(">8I", 0x59A66A95, w, h, depth, n, 1, 0, 0) + bytes(
        range(1, n + 1))
    assert image._sniff(data) == named
    as_jax(tmp_path, "x.ras", data)
    full = (h - 1) * ((w * depth + 15) // 16 * 2) + (w * depth + 7) // 8
    decoded = image.load_rgba8(str(tmp_path / "x.ras")) is not None
    assert decoded == (named == "SUN" and n >= full)


# (width, height, run-length data)
RLE = {"six literals": (3, 2, [1, 2, 3, 4, 5, 6]),
       "run across a row end": (3, 2, [0x80, 3, 7, 9, 9]),
       "80 00": (3, 1, [0x80, 0, 9, 9]),
       "run of 256 over three rows": (3, 3, [0x80, 255, 9]),
       "runs of 0x80": (5, 2, [0x80, 3, 0x80, 0x80, 0x80, 0x80, 0x80, 0,
                               0x80, 1, 0]),
       "data past the image": (2, 1, [0x80, 9, 1, 0x80, 7, 7]),
       # None in both
       "80 00 cut": (3, 1, [0x80, 0, 9]),
       "80 at the end": (3, 1, [0x80, 1, 9, 0x80]),
       "a run cut after its count": (3, 1, [5, 0x80, 3]),
       "empty": (3, 1, [])}
RLE_NONE = ("80 00 cut", "80 at the end", "a run cut after its count",
            "empty")


@pytest.mark.parametrize("case", list(RLE))
def test_sun_rle_records_as_jax(case, tmp_path):
    """``80 00`` is a literal 0x80, ``80 n v`` n + 1 copies of v (on across
    rows, the rest of the run dropped at the image's end), any other byte
    itself; a record or image cut short is None."""
    w, h, stream = RLE[case]
    data = struct.pack(">8I", 0x59A66A95, w, h, 8, 0, 2, 0, 0) + bytes(
        stream)
    as_jax(tmp_path, "x.ras", data)
    decoded = image.load_rgba8(str(tmp_path / "x.ras"))
    assert (decoded is None) == (case in RLE_NONE)


def test_sun_random_rle_streams_as_jax(tmp_path):
    """Streams of 0x80, 0x00 and a few other bytes at random depths and
    widths: what PIL reads or refuses."""
    r = np.random.default_rng(4)
    alphabet = np.array([0x80, 0x80, 0, 1, 2, 255], np.uint8)
    decoded = 0
    for _ in range(120):
        depth = int(r.choice([1, 4, 8, 24, 32]))
        w, h = int(r.integers(1, 9)), int(r.integers(1, 5))
        stream = r.choice(alphabet, int(r.integers(0, 60))).tobytes()
        data = struct.pack(">8I", 0x59A66A95, w, h, depth, 0, 2, 0,
                           0) + stream
        as_jax(tmp_path, "x.ras", data)
        decoded += image.load_rgba8(str(tmp_path / "x.ras")) is not None
    assert decoded > 20


# ---- GBR --------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 4])
@pytest.mark.parametrize("version", [1, 2])
def test_gbr_versions_and_depths_decode_as_jax(version, depth, tmp_path):
    """Depth 1 grey, depth 4 straight RGBA, from ``header_size`` on."""
    px = RGB[..., 0] if depth == 1 else np.concatenate(
        [RGB, RGB[..., 1:2]], 2)
    got = held(tmp_path, "x.gbr", fx.gbr_bytes(px, version) + b"more")
    np.testing.assert_array_equal(got[..., :depth if depth == 4 else 1],
                                  px.reshape(5, 11, -1))


@pytest.mark.parametrize("header_size", [20, 24, 27, 28, 40])
def test_gbr_v2_header_sizes_as_jax(header_size, tmp_path):
    """A version 2 header of 20-27 bytes reads its comment at a negative
    length (to the file's end, so no pixels are left: None); from 28 on,
    the pixels start at ``header_size``."""
    data = fx.gbr_bytes(RGB[..., 1], 2, header_size, b"")
    data += bytes(max(0, header_size - 28)) + RGB[..., 1].tobytes()
    as_jax(tmp_path, "x.gbr", data)
    assert (image.load_rgba8(str(tmp_path / "x.gbr")) is None) == (
        header_size < 28)


# ---- MSP --------------------------------------------------------------------

@pytest.mark.parametrize("size", [(1, 1), (8, 3), (13, 9), (33, 5)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_msp_danm_from_pils_writer_decodes_as_jax(size, tmp_path):
    """PIL's MSP file (``DanM``, raw 1-bit rows, a set bit white);
    ``make_torch_fixtures.msp_bytes`` writes it byte for byte."""
    bits = np.random.default_rng(size[0]).integers(0, 2, size[::-1]).astype(
        np.uint8)
    data = pil_file(Image.fromarray(bits.astype(bool)), "MSP")
    assert fx.msp_bytes(bits) == data
    got = held(tmp_path, "x.msp", data)
    np.testing.assert_array_equal(got[..., 0], 255 * bits)
    held(tmp_path, "x.msp", fx.msp_bytes(bits, rle=True))


def lins(width: int, rows, lengths=None) -> bytes:
    """A ``LinS`` file of the coded ``rows`` (the row map their lengths,
    or ``lengths``)."""
    lengths = [len(r) for r in rows] if lengths is None else lengths
    return (fx.msp_header(b"LinS", width, len(lengths))
            + struct.pack(f"<{len(lengths)}H", *lengths) + b"".join(rows))


# {case: (width, coded rows, row map or None)}
LINS = {"fills and literals": (16, [b"\0\2\xf0", b"\2\x0f\xaa",
                                    b"\0\1\x55\1\1"], None),
        "a row of length 0": (16, [b"\0\2\xf0", b"", b"\2\x0f\xaa"], None),
        "rows of the wrong length": (8, [b"\0\2\xf0", b"\1\x0f", b"\1\x33"],
                                     None),
        "a literal past the row's end": (16, [b"\5\1\2", b"\2\3\4"], None),
        "a fill of count 0": (8, [b"\0\0\7\1\x81", b"\1\x42"], None),
        "a run header cut by the row's end": (8, [b"\1\1\0\2", b"\1\1"],
                                             None),
        "a row short of its length": (8, [b"\1\1", b"\1"], [2, 3]),
        "a short row map": (8, [], [1]),
        "too little data": (16, [b"\1\1", b"\1\1"], None)}


@pytest.mark.parametrize("case", list(LINS))
def test_msp_lins_rows_as_jax(case, tmp_path):
    """The decoded rows joined and cut again at the width: rows that
    decode to 2 and 1 bytes at width 8 read ``F0 / 0F`` and the third
    byte is dropped; a row of length 0 is white; a run header cut by the
    row's end, a short row or row map and too little data are None."""
    width, rows, lengths = LINS[case]
    data = lins(width, rows, lengths)
    if case == "a short row map":
        data = fx.msp_header(b"LinS", 8, 2) + b"\1\0"
    as_jax(tmp_path, "x.msp", data)
    got = image.load_rgba8(str(tmp_path / "x.msp"))
    assert (got is None) == (case.startswith(("a run", "a row short",
                                              "a short", "too")))
    if case == "rows of the wrong length":
        np.testing.assert_array_equal(got[:2, :, 0] // 255, np.unpackbits(
            np.array([[0xF0], [0xF0]], np.uint8), axis=1))
        # (the 2 bytes of row 0 fill rows 0 and 1, row 1's 0x0F is row 2)


# ---- XBM --------------------------------------------------------------------

XBM_HEAD = b"#define x_width 8\n#define x_height 2\nstatic char x_bits[] = {"
XBM = {"single-digit values": XBM_HEAD + b"0x5, 0x1};\n",
       "an x in a comment": XBM_HEAD + b"/* x */ 0x05, 0x01};\n",
       "upper case": XBM_HEAD + b"0xAB, 0xCd};\n",
       "xx": XBM_HEAD + b"0xx1, 0x22};\n",
       "X10 16-bit values": b"#define x_width 16\n#define x_height 1\n"
                            b"static short x_bits[] = {0x1234, 0x5678};\n",
       "_bits[] twice": XBM_HEAD + b"0x01 }; char y_bits[] = {0x11, 0x22};\n",
       "leading white space": b"\n  " + XBM_HEAD + b"0x01, 0x02};\n",
       "CR LF": XBM_HEAD.replace(b"\n", b"\r\n") + b"0x01, 0x02};\n",
       # None in both
       "0X is no x": XBM_HEAD + b"0XAB, 0xCd};\n",
       "cut": XBM_HEAD + b"0x01, 0x0",
       "X10 short of values": b"#define x_width 16\n#define x_height 1\n"
                              b"static short x_bits[] = {0x1234};\n"}


@pytest.mark.parametrize("case", list(XBM))
def test_xbm_values_as_jax(case, tmp_path):
    """PIL's decoder takes each ``x`` and the two bytes after it as hex
    digits (any other byte as 0), so ``0x5,`` is 0x50, an ``x`` in a
    comment is a value of 0 and shifts the rest, and X10 16-bit values
    give their high bytes (too few of them: None; ``0X`` is no value);
    the data starts after the last ``_bits[]`` of the first 512 bytes."""
    as_jax(tmp_path, "x.xbm", XBM[case])
    assert (image.load_rgba8(str(tmp_path / "x.xbm")) is None) == (
        case in ("0X is no x", "cut", "X10 short of values"))


@pytest.mark.parametrize("size", [(1, 1), (8, 2), (13, 9), (37, 5)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_xbm_from_pils_writer_decodes_as_jax(size, tmp_path):
    """PIL's XBM files, with and without a hotspot (rows bit-reversed, a
    set bit white); ``make_torch_fixtures.xbm_bytes`` writes them byte for
    byte."""
    bits = np.random.default_rng(size[0] + 5).integers(0, 2, size[::-1])
    for hotspot in (None, (2, 1)):
        save = {"hotspot": hotspot} if hotspot else {}
        data = pil_file(Image.fromarray(bits.astype(bool)), "XBM", **save)
        assert fx.xbm_bytes(bits.astype(np.uint8), hotspot) == data
        got = held(tmp_path, "x.xbm", data)
        np.testing.assert_array_equal(got[..., 0], 255 * bits)


# ---- XPM --------------------------------------------------------------------

def xpm(values: bytes, colours, rows, pixels=b"") -> bytes:
    """An XPM file of a values line, colour lines and pixel lines."""
    return (b"/* XPM */\nstatic char *x[] = {\n" + values + b"\n"
            + b"".join(c + b"\n" for c in colours) + pixels
            + b"".join(r + b"\n" for r in rows) + b"};\n")


XPM = {
    "P 1-character keys": xpm(b'"3 2 3 1",', [b'"a c #FF0000",',
                                                b'"b c #00ff00",',
                                                b'"c c #0000FF",'],
                              [b'"abc",', b'"cba"']),
    "P 2-character keys": xpm(b'"2 2 2 2",', [b'"aa c #102030",',
                                                b'"ab c #405060",'],
                              [b'"aaab",', b'"abaa"']),
    "#RGB and 48-bit colours": xpm(b'"2 1 2 1",', [b'"a c #F00",',
                                                     b'"b c #123456789ABC",'],
                                   [b'"ab"']),
    "a colour line without its comma": xpm(b'"1 1 1 1",', [b'"a c #FF0000"'],
                                           [b'"a"']),
    "other keys before c": xpm(b'"1 1 1 1",', [b'"a s x m #000 c #123456",'],
                               [b'"a"']),
    "an unused None": xpm(b'"2 1 2 1",', [b'"# c #FF0000",', b'". c None",'],
                          [b'"##"']),
    "a 2-character unused None": xpm(b'"2 1 3 2",', [b'"## c #FF0000",',
                                                     b'".. c None",',
                                                     b'"#. c #00FF00",'],
                                     [b'"###."']),
    "pixel lines joined": xpm(b'"2 2 2 1",', [b'". c #000000",',
                                              b'"# c #FFFFFF",'],
                              [b'".#."', b'"#"']),
    "one long pixel line": xpm(b'"3 3 2 1",', [b'". c #000000",',
                                               b'"# c #FFFFFF",'],
                               [b'".#.#.#.#.",']),
    "comment lines and /* pixels */ twice": xpm(
        b'"2 2 2 1",', [b'". c #000000",', b'"# c #FFFFFF",'],
        [b"/* pixels */", b'".#",', b"/* a comment */", b'"#.",'],
        b"/* pixels */\n"),
    # None in both
    "a key past the image that is no colour": xpm(
        b'"2 1 2 1",', [b'". c #000000",', b'"# c #FFFFFF",'], [b'".#?",']),
    "a colour name": xpm(b'"1 1 1 1",', [b'"a c white",'], [b'"a"']),
    "no c key": xpm(b'"1 1 1 1",', [b'"a m #000000",'], [b'"a"']),
    "a used None": xpm(b'"2 1 2 1",', [b'"a c #FF0000",', b'". c None",'],
                       [b'"a."']),
    "a key that is no colour": xpm(b'"2 1 1 1",', [b'"a c #FF0000",'],
                                   [b'"ab"']),
    "too few pixels": xpm(b'"2 2 1 1",', [b'"a c #FF0000",'], [b'"aa"']),
    "cpp 0": xpm(b'"1 1 1 0",', [b'" c #FF0000",'], [b'"a"']),
}


@pytest.mark.parametrize("case", list(XPM))
def test_xpm_as_jax(case, tmp_path):
    """Only the ``c`` entry counts, its hex value's low 24 bits (``#F00`` is
    (0, 15, 0)); a line without its comma loses its last digit; a
    transparency key no pixel uses sets the alphas of the palette's
    first entries to its bytes; the pixel lines' keys are joined and read
    until they fill the image; a colour name, a used ``None`` key, a key
    that is no colour (past the image's end on the last line read too),
    too few pixels: None."""
    as_jax(tmp_path, "x.xpm", XPM[case])
    got = image.load_rgba8(str(tmp_path / "x.xpm"))
    assert (got is None) == (case in ("a colour name", "no c key",
                                      "a used None",
                                      "a key that is no colour",
                                      "a key past the image that is no "
                                      "colour",
                                      "too few pixels", "cpp 0"))
    if case == "#RGB and 48-bit colours":
        np.testing.assert_array_equal(got[0, :, :3], [[0, 15, 0],
                                                      [120, 154, 188]])
    if case == "an unused None":
        np.testing.assert_array_equal(got[0, :, 3], [46, 46])


@pytest.mark.parametrize("cpp", [1, 2])
@pytest.mark.parametrize("shift", [6, 4], ids=["P", "RGB"])
def test_xpm_quantised_images_decode_as_jax(shift, cpp, tmp_path):
    """``make_torch_fixtures.xpm_bytes`` of a quantised image: 2 bits a
    channel (at most 64 colours, mode ``P``) or 4 (more than 256 colours,
    mode ``RGB``; 1-character keys then run out, and PIL reads the shorter
    file as a key that is no colour: None)."""
    rgb = fx.procedural_rgb(67, 41, 3)
    index, keys, colours = fx.xpm_of(rgb, shift, cpp)
    data = fx.xpm_bytes(index, keys, colours)
    as_jax(tmp_path, "x.xpm", data)
    with Image.open(tmp_path / "x.xpm") as im:
        assert im.mode == ("P" if shift == 6 else "RGB")
    if shift == 6 or cpp == 2:
        got = held(tmp_path, "x.xpm", data)
        np.testing.assert_array_equal(got[..., :3], rgb >> shift << shift)


def test_xpm_rgb_mode_with_a_none_key_is_none_as_in_jax(tmp_path):
    """In an ``RGB`` file (more than 256 colour lines) a ``None`` key is
    the transparency PIL's ``convert_transparent`` refuses as bytes: None
    whether a pixel uses it or not."""
    index, keys, colours = fx.xpm_of(fx.procedural_rgb(67, 41, 5), 4, 2)
    assert len(keys) > 256
    for used in (False, True):
        data = fx.xpm_bytes(index, keys + [b"~~"], colours + [b"None"])
        if used:
            data = data.replace(b'",\n"', b'",\n"~~', 1)
        none_in_both(tmp_path, data, "XPM")


# ---- where a plugin's open fails --------------------------------------------

SUN_HEAD = struct.pack(">8I", 0x59A66A95, 3, 2, 8, 6, 1, 0, 0)


def sun_head(**fields) -> bytes:
    names = ("magic", "width", "height", "depth", "length", "type",
             "map_type", "map_length")
    values = dict(zip(names, struct.unpack(">8I", SUN_HEAD)), **fields)
    return struct.pack(">8I", *(values[k] for k in names))


# {case: (file, the format PIL opens it as: None where no plugin does)}
FALL_THROUGH = {
    # PIL goes on to the next plugin
    "SUN depth 2": (sun_head(depth=2) + bytes(6), None),
    "SUN type 6": (sun_head(type=6) + bytes(6), None),
    "SUN colour map type 2": (sun_head(map_type=2, map_length=6)
                              + bytes(12), None),
    "SUN colour map of 1,025 bytes": (sun_head(map_type=1, map_length=1025)
                                      + bytes(1031), None),
    "SUN width 0": (sun_head(width=0) + bytes(6), None),
    "SUN header cut": (SUN_HEAD[:28], None),
    "GBR depth 2": (struct.pack(">5I", 20, 1, 2, 2, 2) + bytes(8), None),
    "GBR height 0": (struct.pack(">5I", 20, 1, 2, 0, 1) + bytes(8), None),
    "GBR v2 without GIMP": (struct.pack(">5I", 28, 2, 1, 1, 1) + b"GIMQ"
                            + bytes(5), None),
    "GBR v2 cut in its spacing": (struct.pack(">5I", 28, 2, 1, 1, 1)
                                  + b"GIMP\0\0", None),
    "GBR prefix, a TGA": (bytes([0, 0, 2, 0, 0, 0, 0, 1, 0, 0, 0, 0, 3, 0, 2,
                                 0, 24, 0x20]) + bytes(range(18)), "TGA"),
    "MSP checksum": (b"DanM" + bytes(60), None),
    "MSP header cut": (fx.msp_header(b"DanM", 8, 1)[:30], None),
    "MSP width 0": (fx.msp_header(b"LinS", 0, 1) + bytes(4), None),
    "XBM C header": (b"#define FOO 1\nint x;\n", None),
    "XBM _bits[] past 512 bytes": (XBM_HEAD.replace(b"static", b" " * 500
                                                    + b"static")
                                   + b"1, 2};\n", None),
    "XBM width 0": (XBM_HEAD.replace(b"width 8", b"width 0") + b"0x1};",
                    None),
    "XBM no height line": (b"#define x_width 8\nstatic char x_bits[] = "
                           b"{0x1};", None),
    "XPM no values line": (b"/* XPM */\nstatic char *x[] = {\n"
                           b'"w h",\n};\n', None),
    "XPM width 0": (xpm(b'"0 1 1 1",', [b'"a c #000000",'], [b'"a"']), None),
    "XPM c without a value": (xpm(b'"1 1 1 1",', [b'"a c",'], [b'"a"']),
                              None),
    # PIL's open ends in an error: None
    "SUN 1 pixel wide, length 4": (sun_head(width=1, length=4) + bytes(8),
                                   "GBR"),
    "SUN colour map of 771 bytes": (sun_head(map_type=1, map_length=771)
                                    + bytes(777), "SUN"),
    "SUN colour map at depth 1": (sun_head(depth=1, map_type=1, map_length=6)
                                  + bytes(12), "SUN"),
    "SUN colour map at depth 24": (sun_head(depth=24, map_type=1,
                                            map_length=6) + bytes(30), "SUN"),
    "SUN bomb": (sun_head(width=20000, height=20000) + bytes(6), "SUN"),
    "GBR bomb": (struct.pack(">5I", 20, 1, 20000, 20000, 1) + bytes(8),
                 "GBR"),
    "MSP row map cut": (fx.msp_header(b"LinS", 8, 2) + b"\1\0", "MSP"),
    "XBM bomb": (XBM_HEAD.replace(b"width 8", b"width 99999999") + b"0x1};",
                 "XBM"),
    "XPM empty size field": (xpm(b'" 1 1 1",', [b'"a c #000000",'],
                                 [b'"a"']), "XPM"),
    "XPM colour name": (xpm(b'"1 1 1 1",', [b'"a c red",'], [b'"a"']),
                        "XPM"),
    "XPM bad hex": (xpm(b'"1 1 1 1",', [b'"a c #GG0000",'], [b'"a"']),
                    "XPM"),
    "XPM bomb": (xpm(b'"20000 20000 1 1",', [b'"a c #000000",'], [b'"a"']),
                 "XPM"),
}


@pytest.mark.parametrize("case", list(FALL_THROUGH))
def test_open_failures_fall_through_as_in_jax(case, tmp_path):
    """Trouble spot of every plugin: where ``Image.open`` tries the next
    plugin (a ``SyntaxError``, or the errors ``ImageFile`` turns into one,
    no pixels), the port names the format PIL then opens or none (a C
    header that starts ``#define``: none, so None where the port once
    refused it as XBM); where the open or load ends in another error,
    it names this plugin and the file is None, in both packages."""
    data, named = FALL_THROUGH[case]
    assert image._sniff(data) == named
    as_jax(tmp_path, "x.bin", data)
    if named != "TGA":
        assert image.load_rgba(str(tmp_path / "x.bin")) is None


# ---- the committed fixtures and the card's maps -----------------------------

BITMAP_FIXTURES = ["small_rle.ras", "small_pal.ras", "small_24.ras",
                   "small_32_rle.ras", "small_1.ras", "small_v1.gbr",
                   "small_v2.gbr", "small.msp", "small_rle.msp", "small.xbm",
                   "small.xpm"]


@pytest.mark.parametrize("name", BITMAP_FIXTURES)
def test_small_fixtures_decode_as_jax(name, tmp_path):
    with open(os.path.join(DATA, name), "rb") as f:
        assert held(tmp_path, name, f.read()).shape == (9, 13, 4)


with open(os.path.join(DATA, "bitmap_map_digests.json")) as _f:
    BITMAP_DIGESTS = json.load(_f)


def test_bitmap_map_digests_name_every_map():
    assert sorted(BITMAP_DIGESTS) == sorted(fx.BITMAP_MAPS)


@pytest.mark.parametrize("name", sorted(fx.BITMAP_MAPS))
def test_bitmap_maps_decode_to_recorded_digests(name, tmp_path):
    """The maps ``chip_smoke.py`` makes and times are the files
    ``tests/torch_data/bitmap_map_digests.json`` records, and the port
    decodes each to PIL's recorded decode, which ``chip_smoke.py`` holds
    the card machine's decode to."""
    want = BITMAP_DIGESTS[name]
    data = fx.bitmap_map(name)
    assert hashlib.sha256(data).hexdigest() == want["file_sha256"]
    path = tmp_path / name
    path.write_bytes(data)
    got = image.load_rgba8(str(path))
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["rgba_sha256"]


# ---- scenes -----------------------------------------------------------------

def sun_and_xpm(tmp_path):
    """Paths of a 64x48 run-length SUN roughness map and a 48x40 RGB XPM
    normal map (4 bits a channel, 2-character keys)."""
    rough = tmp_path / "rough.ras"
    rough.write_bytes(fx.sun_bytes(fx.procedural_rgb(64, 48, 5)[..., 1], 8,
                                   2))
    normal = tmp_path / "normal.xpm"
    normal.write_bytes(fx.xpm_bytes(*fx.xpm_of(fx.normal_map(48, 3)[:40], 4,
                                               2)))
    return str(rough), str(normal)


def test_sun_and_xpm_mapped_hier_trace_matches_jax_under_one_key(tmp_path):
    """The glossy wall of ``normal_mapped_wall`` with the two maps, the port
    through ``"hier"`` (the BVH walk the card sessions run; its plain
    version here) against the JAX package's dense trace (rtol 1e-4 /
    atol 1e-6)."""
    rough, normal = sun_and_xpm(tmp_path)
    for path in (rough, normal):
        with open(path, "rb") as f:
            held(tmp_path, "x.bin", f.read())
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


_NO_JAX_BITMAPS = r"""
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
from pathtracing_spectrum_tpu_torch.utils import bitmaps, image

spec = importlib.util.spec_from_file_location(
    "fx", os.path.join(sys.argv[1], "tools", "make_torch_fixtures.py"))
fx = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fx)
tmp, assets = sys.argv[2], os.path.join(sys.argv[1], "assets")
data_dir = os.path.join(sys.argv[1], "tests", "torch_data")
for name in sys.argv[3].split(","):
    assert image.load_rgba8(os.path.join(data_dir, name)).shape == (9, 13, 4)
rough = os.path.join(tmp, "r.ras")
with open(rough, "wb") as f:
    f.write(fx.sun_bytes(fx.procedural_rgb(40, 24, 3)[..., 1], 8, 2))
normal = os.path.join(tmp, "n.xpm")
with open(normal, "wb") as f:
    f.write(fx.xpm_bytes(*fx.xpm_of(fx.procedural_rgb(32, 32, 2), 4, 2)))
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


def test_bitmap_mapped_render_imports_neither_jax_nor_pil(tmp_path):
    """``utils/bitmaps.py`` and what it reads load without jax and PIL."""
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_BITMAPS, REPO, str(tmp_path),
         ",".join(BITMAP_FIXTURES)], capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
