"""The FLI/FLC, Kodak PhotoCD and IPTC/NAA files the port reads in
``utils/fli_pcd_iptc.py`` against the JAX package (PIL): the port's
``load_rgba`` bit for bit as an int32 view of the float32 and its
``load_rgba8`` as uint8 (tolerance 0), None where it is None, apart from
the mapped trace's rtol 1e-4 / atol 1e-6, as
``tests/test_torch_spectral.py`` states it.

- FLI (0xAF11) and FLC (0xAF12): each subchunk type (SS2, LC, BLACK,
  BRUN, COPY; the colour chunks and a postage stamp skipped); PIL's
  bounds (a short last subchunk, an unknown type, advances of 0 and past
  the frame, packets past a line, lines past the image, a frame longer
  than the file and its odd last byte); the prefix chunk (the palette
  found past it, the frame not: None); colour packets (skips, a count of
  0, an index past 255, 6-bit values past 63); header flags other than 0
  or 3 and the reserved fields; a multi-frame file, of which only the
  first frame is read; random BRUN, LC and SS2 streams.
- PCD: orientations 0-3, a short header and a short body, a seeded file
  of PhotoYCC triples and the conversion against PIL's ``YCC;P``
  unpacker over a seeded sample.
- IPTC: raw ``L``, raw under a band of RGB and of CMYK, PIL's JPEG and a
  PNG under compression 5 (the PNG's ``tRNS`` unapplied), an RGB image
  under a band, a grey JPEG under one, a missing (3, 60), an unknown and
  a missing compression, every field-length form, two (8, 10) fields, an
  embedded format the port refuses (naming the IPTC file and the inner
  format).
- The committed fixtures and the card's maps against their recorded
  digests, a ``"hier"`` trace with a BRUN FLC roughness map and a PCD
  normal map against the JAX package's dense one, and a render from such
  maps in a process that refuses to import jax and PIL.

``tools/fli_pcd_iptc_sweep.py`` is the wide sweep: random files of each
kind, their cuts and flips, and every PhotoYCC triple.
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
from pathtracing_spectrum_tpu_torch import engine  # noqa: E402
from pathtracing_spectrum_tpu_torch.ops import rng  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import (  # noqa: E402
    fli_pcd_iptc, image)

from PIL import Image  # noqa: E402

from test_torch_readers import as_jax, held  # noqa: E402
from test_torch_scene import to_port_scene  # noqa: E402
from test_torch_spectral import assert_same  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402
from test_torch_qoi_dds import REPO, fx  # noqa: E402

DATA = os.path.join(REPO, "tests", "torch_data")
INDEX = np.random.default_rng(29).integers(0, 256, (9, 13), np.uint8)
INDEX[2, 3:11] = 5                                   # runs for the codecs
PALETTE = np.random.default_rng(30).integers(0, 256, (256, 3), np.uint8)


def fli(chunks, w=13, h=9, magic=0xAF12, **kw) -> bytes:
    return fx.fli_bytes(w, h, [fx.fli_frame(chunks)], magic=magic, **kw)


def colour(shift=0, skips=None, pal=PALETTE):
    """A colour chunk (4, or 11 at ``shift`` 2) of ``pal``."""
    return fx.fli_chunk(11 if shift else 4, fx.fli_colour(
        pal >> shift, skips or [(0, 256)]))


# ---- FLI --------------------------------------------------------------------

SUBCHUNKS = {
    "BRUN under a 256-entry palette": [colour(), fx.fli_chunk(
        15, fx.fli_brun(INDEX))],
    "BRUN under a 6-bit palette": [colour(2), fx.fli_chunk(
        15, fx.fli_brun(INDEX))],
    "LC from line 3": [colour(), fx.fli_chunk(12, fx.fli_lc(INDEX[3:], 3,
                                                              4))],
    "LC of no lines": [colour(), fx.fli_chunk(12, struct.pack("<HH", 2, 0))],
    "SS2 every line": [colour(), fx.fli_chunk(7, fx.fli_ss2(INDEX))],
    "SS2 with line skips": [colour(), fx.fli_chunk(7, fx.fli_ss2(INDEX, 3))],
    "SS2 of even width": [fx.fli_chunk(7, fx.fli_ss2(INDEX[:, :12]))],
    "COPY": [colour(), fx.fli_chunk(16, INDEX.tobytes())],
    "BLACK after BRUN": [fx.fli_chunk(15, fx.fli_brun(INDEX)),
                         fx.fli_chunk(13, b""), fx.fli_chunk(18, bytes(4))],
    "BRUN, SS2 and LC over it": [
        colour(), fx.fli_chunk(15, fx.fli_brun(INDEX)),
        fx.fli_chunk(7, fx.fli_ss2(INDEX[::-1], 2)),
        fx.fli_chunk(12, fx.fli_lc(INDEX[4:6, ::-1], 1, 3))],
    "a postage stamp and a late colour chunk skipped": [
        fx.fli_chunk(18, bytes(20)), fx.fli_chunk(15, fx.fli_brun(INDEX)),
        colour()],
    "no subchunks": [],
}


@pytest.mark.parametrize("magic", [0xAF11, 0xAF12], ids=["FLI", "FLC"])
@pytest.mark.parametrize("case", list(SUBCHUNKS))
def test_fli_subchunks_decode_as_jax(case, magic, tmp_path):
    chunks = SUBCHUNKS[case]
    w = 12 if case == "SS2 of even width" else 13
    assert image._sniff(fli(chunks, w, magic=magic)) == "FLI"
    held(tmp_path, "x.flc", fli(chunks, w, magic=magic))


def _short_last(kind: int, body: bytes) -> bytes:
    return fli([fx.fli_chunk(15, fx.fli_brun(INDEX)), fx.fli_chunk(kind,
                                                                  body)])


FRAME_BOUNDS = {
    # a last subchunk that leaves fewer than 10 bytes is an overrun
    "a 6-byte BLACK last": _short_last(13, b""),
    "a 9-byte PSTAMP last": _short_last(18, b"abc"),
    "a 10-byte PSTAMP last": _short_last(18, b"abcd"),
    "an unknown type": fli([fx.fli_chunk(15, fx.fli_brun(INDEX)),
                            fx.fli_chunk(9, bytes(8))]),
    "an advance of 0": fli([fx.fli_chunk(15, fx.fli_brun(INDEX), size=0)]),
    "an advance past the frame": fli([fx.fli_chunk(
        15, fx.fli_brun(INDEX), size=4000)]),
    "an advance short of the data": fli([
        fx.fli_chunk(16, INDEX.tobytes(), size=20),
        fx.fli_chunk(13, bytes(200))]),
    "BRUN past a line": fli([fx.fli_chunk(15, b"\0\x0e\x01" + bytes(40))]),
    "BRUN short of a line": fli([fx.fli_chunk(15, fx.fli_brun(
        INDEX)[:-4])]),
    "LC lines past the image": fli([fx.fli_chunk(12, fx.fli_lc(INDEX, 2,
                                                                4))]),
    "LC packet past a line": fli([fx.fli_chunk(
        12, struct.pack("<HH", 0, 1) + b"\x01\x0c\x0d" + bytes(13))]),
    "SS2 skip past the image": fli([fx.fli_chunk(
        7, struct.pack("<HHH", 1, 0xFFF0, 0) + bytes(8))]),
    "SS2 lines past the image": fli([fx.fli_chunk(
        7, struct.pack("<H", 10) + b"".join(
            struct.pack("<H", 0) for _ in range(10)))]),
    "SS2 pairs past a line": fli([fx.fli_chunk(
        7, struct.pack("<HH", 1, 1) + b"\x08\xfd\x01\x02" + bytes(8))]),
    "COPY short": fli([fx.fli_chunk(16, INDEX.tobytes()[:-1])]),
    "a frame longer than the file": fli([fx.fli_chunk(
        16, INDEX.tobytes())])[:-2],
    "a frame cut inside its last subchunk": fli([
        fx.fli_chunk(16, INDEX.tobytes()), fx.fli_chunk(18, bytes(9))])[:-1],
    # an odd frame padded to an even size (its size field one more), the
    # file ending before the pad: PIL's decoder takes the frame
    "a frame padded to an even size, the pad missing": fli([])[:128]
    + fx.fli_frame([fx.fli_chunk(16, INDEX.tobytes())], size=140)[:139],
    "a frame size of 0": fli([])[:128] + bytes(16),
    "a frame size of 7": fli([])[:128] + struct.pack("<IHH", 7, 0xF1FA, 0)
    + bytes(8),
    "a frame size of 8 and no subchunks": fli([])[:128] + struct.pack(
        "<IHH", 8, 0xF1FA, 0),
    "a frame of another type": fli([])[:132] + b"\x00\xf2" + bytes(10),
}


@pytest.mark.parametrize("case", list(FRAME_BOUNDS))
def test_fli_frame_bounds_as_jax(case, tmp_path):
    """FliDecode.c's bounds and ImageFile.load's reads: where PIL fails
    the file is None in both; the frame without its pad byte and the
    8-byte one decode."""
    assert image._sniff(FRAME_BOUNDS[case]) == "FLI"
    as_jax(tmp_path, "x.flc", FRAME_BOUNDS[case])
    assert (image.load_rgba(str(tmp_path / "x.flc")) is None) == (
        case not in ("a frame padded to an even size, the pad missing",
                     "a frame size of 8 and no subchunks",
                     "a 10-byte PSTAMP last"))


PALETTES = {
    "skips": [colour(0, [(3, 10), (200, 20), (0, 1)]),
              fx.fli_chunk(16, INDEX.tobytes())],
    "a count of 0 (256 colours)": [colour(0, [(0, 256)]),
                                   fx.fli_chunk(16, INDEX.tobytes())],
    "6-bit values past 63 (the low 8 bits kept)": [
        fx.fli_chunk(11, fx.fli_colour(PALETTE)),
        fx.fli_chunk(16, INDEX.tobytes())],
    "an index past 255": [colour(0, [(250, 10)]),
                          fx.fli_chunk(16, INDEX.tobytes())],
    "a colour cut short": [fx.fli_chunk(4, struct.pack("<HBB", 1, 0, 2)
                                        + bytes(4))],
    "no colour chunk (a grey ramp)": [fx.fli_chunk(16, INDEX.tobytes())],
    "after a chunk of another type": [fx.fli_chunk(16, INDEX.tobytes()),
                                      colour(2)],
    "after a chunk of size 0 (not searched)": [
        fx.fli_chunk(18, bytes(4), size=0), colour()],
}


@pytest.mark.parametrize("case", list(PALETTES))
def test_fli_palettes_as_jax(case, tmp_path):
    as_jax(tmp_path, "x.flc", fli(PALETTES[case]))


def _prefixed(pal_in_frame: bool, skips=None) -> bytes:
    body = [colour(0, skips), fx.fli_chunk(16, INDEX.tobytes())]
    return fli(body if pal_in_frame else body[1:],
               prefix=fx.fli_chunk(0xF100, bytes(20)))


FALL_THROUGH = {
    # (bytes, the format PIL then opens or None)
    "flags 1": (fli([fx.fli_chunk(16, INDEX.tobytes())], flags=1), None),
    "a reserved byte set": (fli([fx.fli_chunk(16, INDEX.tobytes())])[:50]
                            + b"\x01" + fli([])[51:], None),
    "no frames": (fli([fx.fli_chunk(16, INDEX.tobytes())], n_frames=0),
                  None),
    "no frame header": (fli([])[:128], None),
    "two bytes of frame": (fli([])[:130], None),
    "a width of 0": (fli([fx.fli_chunk(16, b"")], w=0), None),
    "a colour index past 255": (fli(PALETTES["an index past 255"]), None),
    "the prefix chunk, its palette found": (_prefixed(True), "FLI"),
    "the prefix chunk, no palette": (_prefixed(False), "FLI"),
    "the prefix chunk, a colour past 255": (_prefixed(True, [(250, 10)]),
                                            None),
}


@pytest.mark.parametrize("case", list(FALL_THROUGH))
def test_fli_open_failures_fall_through_as_in_jax(case, tmp_path):
    """Where FliImageFile._open fails, PIL tries the next plugin (none
    here: None); a file that starts with a prefix chunk opens, and its
    frame at byte 128, the prefix chunk, fails the decoder: None."""
    data, named = FALL_THROUGH[case]
    assert image._sniff(data) == named
    as_jax(tmp_path, "x.flc", data)
    assert image.load_rgba(str(tmp_path / "x.flc")) is None


def test_fli_multi_frame_file_reads_its_first_frame(tmp_path):
    frames = [fx.fli_frame([colour(), fx.fli_chunk(15, fx.fli_brun(
        INDEX))]), fx.fli_frame([fx.fli_chunk(16, bytes(117))]),
        fx.fli_frame([fx.fli_chunk(13, b"")])]
    data = fx.fli_bytes(13, 9, frames)
    got = held(tmp_path, "x.flc", data)
    np.testing.assert_array_equal(got[..., :3], PALETTE[INDEX])


@pytest.mark.parametrize("kind", ["BRUN", "LC", "SS2"])
def test_fli_random_streams_as_jax(kind, tmp_path):
    """Random packet streams of each delta kind, cut at random points:
    PIL's bounds decide which decode."""
    rng_ = np.random.default_rng({"BRUN": 1, "LC": 2, "SS2": 3}[kind])
    for i in range(40):
        w, h = int(rng_.integers(1, 24)), int(rng_.integers(1, 8))
        index = rng_.integers(0, 256, (h, w), np.uint8)
        index[:, :w // 2] = index[:, :1]
        if kind == "BRUN":
            body = fx.fli_brun(index)
        elif kind == "LC":
            body = fx.fli_lc(index, 0, int(rng_.integers(1, 6)))
        else:
            body = fx.fli_ss2(index, int(rng_.integers(1, 3)))
        if i % 2:
            cut = int(rng_.integers(0, len(body) + 1))
            raw = bytearray(body[:cut] + bytes(int(rng_.integers(0, 12))))
            if raw:
                raw[int(rng_.integers(0, len(raw)))] = int(
                    rng_.integers(0, 256))
            body = bytes(raw)
        code = {"BRUN": 15, "LC": 12, "SS2": 7}[kind]
        as_jax(tmp_path, "x.flc", fli([fx.fli_chunk(code, body)], w, h))


# ---- PCD --------------------------------------------------------------------

PCD_RGB = fx.procedural_rgb(768, 512, 31)


@pytest.mark.parametrize("orientation", [0, 1, 2, 3, 5, 255])
def test_pcd_orientations_decode_as_jax(orientation, tmp_path):
    """The low two bits of byte 3,586: 1 and 3 turn the 768x512 image
    by 90 and 270 degrees (512x768), 0 and 2 leave it."""
    data = fx.pcd_bytes(*fx.pcd_of(PCD_RGB, 31), orientation=orientation)
    got = held(tmp_path, "x.pcd", data)
    assert got.shape == ((768, 512, 4) if orientation & 1 else
                         (512, 768, 4))


@pytest.mark.parametrize("length", [3586, 3587, 196608, 786431, 786432,
                                    786433])
def test_pcd_short_header_and_body_as_jax(length, tmp_path):
    """A file shorter than 2,048 + 1,539 bytes goes on to the next plugin
    (none: None); a body short of 768 x 512 x 1.5 bytes is "image file is
    truncated" (None); bytes past it are not read."""
    whole = fx.pcd_bytes(*fx.pcd_of(PCD_RGB, 32))
    data = (whole + b"\xff")[:length]
    assert image._sniff(data) == (None if length < 3587 else "PCD")
    as_jax(tmp_path, "x.pcd", data)
    assert (image.load_rgba(str(tmp_path / "x.pcd")) is None) == (
        length < 786432)


def test_pcd_of_random_ycc_triples_decodes_as_jax(tmp_path):
    r = np.random.default_rng(33)
    data = fx.pcd_bytes(r.integers(0, 256, (512, 768), np.uint8),
                        r.integers(0, 256, (256, 384), np.uint8),
                        r.integers(0, 256, (256, 384), np.uint8))
    held(tmp_path, "x.pcd", data)


def test_ycc_conversion_is_pils_unpacker_on_a_sample():
    """``ycc_rgb`` against PIL's ``YCC;P`` unpacker over 2^18 seeded
    triples (``tools/fli_pcd_iptc_sweep.py`` holds all 2^24)."""
    trip = np.random.default_rng(34).integers(0, 256, (512, 512, 3),
                                              np.uint8)
    want = np.asarray(Image.frombytes("RGB", (512, 512), trip.tobytes(),
                                      "raw", "YCC;P"))
    got = fli_pcd_iptc.ycc_rgb(trip[..., 0], trip[..., 1], trip[..., 2])
    np.testing.assert_array_equal(got, want)


# ---- IPTC -------------------------------------------------------------------

GREY = np.random.default_rng(35).integers(0, 256, (9, 13), np.uint8)
GREY[4, :3] = 7                                  # the tRNS case's key
RGB = np.random.default_rng(36).integers(0, 256, (9, 13, 3), np.uint8)


def _png(px, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "PNG", **kw)
    return buf.getvalue()


def _field_forms() -> dict:
    raw = GREY.tobytes()
    head = fx.iptc_bytes(13, 9, b"")
    out = {f"image field, {n}-byte length": head + fx.iptc_field(
        8, 10, raw, n) for n in (1, 2, 3, 4)}
    out["a size-0 field (128)"] = fx.iptc_bytes(
        13, 9, raw, extra=b"\x1c\x02\x05\x80\x00")
    out["a length byte of 133"] = head + b"\x1c\x08\x0a\x85\x00" + raw
    out["a length byte of 133 before the image"] = fx.iptc_bytes(
        13, 9, raw, extra=b"\x1c\x02\x05\x85\x00")
    # (read as a 5-byte length of 0, the record would open and decode)
    out["a length byte of 133, five zero bytes after"] = fx.iptc_bytes(
        13, 9, raw, extra=b"\x1c\x02\x05\x85\x00" + bytes(5))
    out["a length past the file"] = head + fx.iptc_field(8, 10, raw)[:5]
    return out


IPTC = {
    "raw L": fx.iptc_bytes(13, 9, GREY.tobytes()),
    "raw L, data to spare": fx.iptc_bytes(13, 9, GREY.tobytes() + bytes(9)),
    "raw L, data short": fx.iptc_bytes(13, 9, GREY.tobytes()[:-1]),
    "two image fields": fx.iptc_bytes(13, 9, GREY.tobytes(), chunk=50),
    "image fields, then another field": fx.iptc_bytes(
        13, 9, GREY.tobytes(), chunk=100) + fx.iptc_field(2, 5, b"x"),
    **{f"raw band {b} of RGB": fx.iptc_bytes(13, 9, GREY.tobytes(), 3, 1,
                                             band=b) for b in (1, 2, 3)},
    **{f"raw band {b} of CMYK": fx.iptc_bytes(13, 9, GREY.tobytes(), 4, 1,
                                              band=b) for b in (1, 2, 3, 4)},
    "raw RGB without a band field": fx.iptc_bytes(13, 9, GREY.tobytes(), 3,
                                                  2),
    "raw band 0 (the last)": fx.iptc_bytes(13, 9, GREY.tobytes(), 3, 1,
                                           band=0),
    "raw band 4 of RGB": fx.iptc_bytes(13, 9, GREY.tobytes(), 3, 1, band=4),
    "JPEG in L": fx.iptc_bytes(13, 9, fx.pil_jpeg(RGB), compression=5),
    "grey JPEG in L": fx.iptc_bytes(13, 9, fx.pil_jpeg(GREY),
                                    compression=5),
    "PNG in L": fx.iptc_bytes(13, 9, _png(RGB), compression=5),
    "PNG with tRNS in L": fx.iptc_bytes(13, 9, _png(GREY, transparency=7),
                                        compression=5),
    "a larger PNG than the record's size": fx.iptc_bytes(
        2, 2, _png(RGB), compression=5),
    "RGB JPEG under band 2": fx.iptc_bytes(13, 9, fx.pil_jpeg(RGB), 3, 1,
                                           compression=5, band=2),
    "RGB JPEG under band 1": fx.iptc_bytes(13, 9, fx.pil_jpeg(RGB), 3, 1,
                                           compression=5, band=1),
    "grey JPEG under band 2": fx.iptc_bytes(13, 9, fx.pil_jpeg(GREY), 3, 1,
                                            compression=5, band=2),
    "grey PNG under band 3 of CMYK": fx.iptc_bytes(13, 9, _png(GREY), 4, 1,
                                                   compression=5, band=3),
    "text under compression 5": fx.iptc_bytes(13, 9, b"<p>no image</p>" * 9,
                                               compression=5),
    "an unknown compression": fx.iptc_bytes(13, 9, GREY.tobytes(),
                                            compression=3),
    "no compression field": fx.iptc_bytes(13, 9, GREY.tobytes()).replace(
        fx.iptc_field(3, 120, b"\x01"), b""),
    "no (3, 60) field": fx.iptc_bytes(13, 9, GREY.tobytes()).replace(
        fx.iptc_field(3, 60, b"\x01\x00"), b""),
    "(3, 60) twice": fx.iptc_bytes(13, 9, GREY.tobytes(), extra=fx.iptc_field(
        3, 60, b"\x01\x00")),
    "layers 1 with a component": fx.iptc_bytes(13, 9, GREY.tobytes(), 1, 1),
    "a width of 0": fx.iptc_bytes(0, 9, GREY.tobytes()),
    "no image field": fx.iptc_bytes(13, 9, b""),
    "a record number of 10": b"\x1c\x0a\x00\x00\x02ab",
    **_field_forms(),
}


@pytest.mark.parametrize("case", list(IPTC))
def test_iptc_as_jax(case, tmp_path):
    as_jax(tmp_path, "x.iim", IPTC[case])
    if case.startswith("a length byte of 133"):
        assert image.load_rgba(str(tmp_path / "x.iim")) is None


@pytest.mark.parametrize("case, named", [
    ("no compression field", "IPTC"), ("an unknown compression", "IPTC"),
    ("a length byte of 133 before the image", "IPTC"),
    ("a length byte of 133, five zero bytes after", "IPTC"),
    ("no (3, 60) field", None), ("(3, 60) twice", None),
    ("layers 1 with a component", None), ("a width of 0", None),
    ("a record number of 10", None)])
def test_iptc_open_errors_end_or_fall_through_as_in_pil(case, named):
    """An ``OSError`` of IptcImageFile._open (a length byte above 132, a
    compression other than 1 or 5, or none) ends PIL's open: the file is
    IPTC's and None; a ``KeyError``, ``TypeError``, ``SyntaxError``, no
    mode or no pixels sends PIL to the next plugin (none here)."""
    assert image._sniff(IPTC[case]) == named


def test_iptc_raw_band_lands_in_its_channel(tmp_path):
    got = held(tmp_path, "x.iim", IPTC["raw band 2 of RGB"])
    np.testing.assert_array_equal(got[..., 1], GREY)
    assert not got[..., [0, 2]].any() and (got[..., 3] == 255).all()


@pytest.mark.parametrize("inner", ["WMF", "GIF"])
def test_iptc_refused_inner_format_names_the_file_and_format(inner,
                                                             tmp_path):
    body = (b"\xd7\xcd\xc6\x9a\x00\x00" + bytes(60) if inner == "WMF" else
            _gif(GREY))
    path = tmp_path / "record.iim"
    path.write_bytes(fx.iptc_bytes(13, 9, body, compression=5))
    with pytest.raises(NotImplementedError, match=f"record.iim.*{inner}"):
        image.load_rgba(str(path))


def _gif(px) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "GIF")
    return buf.getvalue()


# ---- the committed fixtures and the card's maps -----------------------------

FIXTURES = ["small.fli", "small_lc.fli", "small.flc", "small.iim",
            "small_band.iim", "small_jpeg.iim"]


@pytest.mark.parametrize("name", FIXTURES)
def test_small_fixtures_decode_as_jax(name, tmp_path):
    with open(os.path.join(DATA, name), "rb") as f:
        assert held(tmp_path, name, f.read()).shape == (9, 13, 4)


with open(os.path.join(DATA, "fli_pcd_iptc_map_digests.json")) as _f:
    MAP_DIGESTS = json.load(_f)


def test_map_digests_name_every_map():
    assert sorted(MAP_DIGESTS) == sorted(fx.FLI_PCD_IPTC_MAPS)


@pytest.mark.parametrize("name", sorted(fx.FLI_PCD_IPTC_MAPS))
def test_maps_decode_to_recorded_digests(name, tmp_path):
    """The maps ``chip_smoke.py`` makes and times are the files
    ``tests/torch_data/fli_pcd_iptc_map_digests.json`` records, and the
    port decodes each to PIL's recorded decode, which ``chip_smoke.py``
    holds the card machine's decode to."""
    want = MAP_DIGESTS[name]
    data = fx.fli_pcd_iptc_map(name)
    assert hashlib.sha256(data).hexdigest() == want["file_sha256"]
    path = tmp_path / name
    path.write_bytes(data)
    got = image.load_rgba8(str(path))
    assert list(got.shape) == want["shape"]
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["rgba_sha256"]


# ---- scenes -----------------------------------------------------------------

def flc_and_pcd(tmp_path):
    """Paths of a 64x48 BRUN FLC roughness map and a PhotoCD normal map."""
    rough = tmp_path / "rough.flc"
    index = fx.procedural_rgb(64, 48, 5)[..., 1]
    rough.write_bytes(fx.fli_bytes(64, 48, [fx.fli_frame([
        colour(), fx.fli_chunk(15, fx.fli_brun(index))])]))
    normal = tmp_path / "normal.pcd"
    normal.write_bytes(fx.pcd_bytes(*fx.pcd_of(fx.normal_map(768)[:512],
                                               6)))
    return str(rough), str(normal)


def test_flc_and_pcd_mapped_hier_trace_matches_jax_under_one_key(tmp_path):
    """The glossy wall of ``normal_mapped_wall`` with the two maps, the port
    through ``"hier"`` (the BVH walk the card sessions run; its plain
    version here) against the JAX package's dense trace (rtol 1e-4 /
    atol 1e-6)."""
    rough, normal = flc_and_pcd(tmp_path)
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


_NO_JAX_FLI_PCD_IPTC = r"""
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
from pathtracing_spectrum_tpu_torch.utils import image, jpeg

spec = importlib.util.spec_from_file_location(
    "fx", os.path.join(sys.argv[1], "tools", "make_torch_fixtures.py"))
fx = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fx)
tmp, assets = sys.argv[2], os.path.join(sys.argv[1], "assets")
data_dir = os.path.join(sys.argv[1], "tests", "torch_data")
for name in sys.argv[3].split(","):
    assert image.load_rgba8(os.path.join(data_dir, name)).shape == (9, 13, 4)
rough = os.path.join(tmp, "r.flc")
with open(rough, "wb") as f:
    f.write(fx.fli_bytes(40, 24, [fx.fli_frame([fx.fli_chunk(
        15, fx.fli_brun(fx.procedural_rgb(40, 24, 3)[..., 1]))])]))
normal = os.path.join(tmp, "n.iim")
with open(normal, "wb") as f:
    f.write(fx.iptc_bytes(32, 32, jpeg.encode(fx.procedural_rgb(32, 32, 2)),
                          compression=5))
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


def test_fli_iptc_mapped_render_imports_neither_jax_nor_pil(tmp_path):
    """``utils/fli_pcd_iptc.py`` and what it reads load without jax and
    PIL."""
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_FLI_PCD_IPTC, REPO,
         str(tmp_path), ",".join(FIXTURES)], capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
