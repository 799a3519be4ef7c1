"""The port's run-length BMP and DIB reader, its ICO reader's DIB frames,
its CUR reader and its ICNS reader's RLE, mask and JPEG 2000 entries
(``utils/image.py`` over the host library's ``csrc/lzw_decode.cpp``)
against the JAX package (PIL 12.1), exact everywhere (tolerance 0:
pixels, and ``load_rgba`` as an int32 view; None exactly where the JAX
package gives None), apart from the mapped trace's rtol 1e-4 / atol 1e-6,
as ``tests/test_torch_spectral.py`` states it.

- RLE8 and RLE4 at widths 1-9 and 33, bottom-up and top-down, grey and
  colour palettes, as a BMP with its pixels at an even and at an odd
  offset and as a DIB: streams of every escape, made as PIL reads them
  (runs past the row's end, the four-byte delta, odd absolute runs in
  RLE4, padding by the file offset, ends of line and of bitmap); named
  edge cases (data that runs out, too much data, the delta cut short, a
  grey two-entry palette, RLE at 24 bits, compressions 4 and 5).
- ICO: PIL's writer with ``bitmap_format="bmp"`` in modes 1, L, P, RGB
  and RGBA from 1x1 to 48x48 and 256x256, files of several sizes and bit
  depths (the directory's sort picks the frame), and hand-built 1-, 4-,
  8-, 24- and 32-bit frames (the AND mask from the end of the entry's
  resource, the 32-bit alpha where the entry says 32 bits, sizes that
  are not the directory's).
- CUR: one and two entries at 24 and 32 bits (the alpha of a 32-bit
  bitmap at byte 22 only), PIL's largest-cursor rule, an offset of 0.
- ICNS: ``is32``, ``il32``, ``ih32`` and ``it32`` with and without their
  masks, run-length and uncompressed, and JP2 and J2K ``ic08`` and
  ``ic09`` entries PIL writes at its defaults, with named edge cases.
- Every cut of a small file of each kind, 200 files with damaged pixel
  data, the reader maps' recorded digests, a scene with an RLE BMP
  roughness map and a DIB-framed ICO normal map compiled and traced
  against the JAX package, and, in a process that refuses to import jax
  and PIL, a render from such maps and CUR and ICNS files read.
"""

import hashlib
import json
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
from pathtracing_spectrum_tpu_torch.utils import image, jpeg2000  # noqa: E402,E501

import torch_images as ti  # noqa: E402
from scene_helpers import cornell_scene  # noqa: E402
from test_torch_pdf_ico_icns import block, icns_file, ico_file  # noqa: E402
from test_torch_readers import as_jax, held, pil_file  # noqa: E402
from test_torch_scene import assert_fields_equal, to_port_scene  # noqa: E402,E501
from test_torch_spectral import assert_same, trace_both  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402
from test_torch_qoi_dds import REPO, fx  # noqa: E402


def palette(kind: str, n: int, seed: int) -> bytes:
    """``n`` BGRX entries: grey (index i is (i, i, i); with two entries 0
    and 255, PIL's mode 1) or random colours."""
    if kind == "grey":
        values = (0, 255) if n == 2 else range(n)
        return b"".join(bytes((v, v, v, 0)) for v in values)
    return np.random.default_rng(seed).integers(0, 256, 4 * n,
                                                np.uint8).tobytes()


def bmp(w: int, h: int, bits: int, compression: int, pixels: bytes,
        pal: bytes = b"", colors: int = 0, top: bool = False, gap: int = 0,
        dib: bool = False) -> bytes:
    """A BMP (``gap`` bytes between the palette and the pixels, the file
    header's offset pointing past them) or, with ``dib``, a DIB (the
    pixels right after the palette) of a BITMAPINFOHEADER."""
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top else h, 1, bits,
                       compression, len(pixels), 0, 0, colors, 0)
    if dib:
        return info + pal + pixels
    offset = 14 + 40 + len(pal) + gap
    return (b"BM" + struct.pack("<IHHI", offset + len(pixels), 0, 0, offset)
            + info + pal + bytes(gap) + pixels)


def rle_packets(rng, w: int, h: int, rle4: bool, at: int) -> bytes:
    """A stream of RLE8 (or RLE4) packets that fills ``w * h`` pixels as
    PIL's BmpRleDecoder reads it, the first packet at file offset ``at``:
    first a delta (two bytes PIL skips, then right and up), an absolute
    run (odd in RLE4: PIL reads ``n // 2`` bytes and moves ``x`` by n), a
    run past the row's end (cut there) and an end of line, then such
    packets at random until the pixels are out, then an end of bitmap
    (which PIL does not reach). An absolute run is padded where PIL's
    file position is odd after it."""
    out, n, x = bytearray(), 0, 0
    forced = ["delta", "absolute", "over", "eol"]
    while n < w * h:
        kind = forced.pop(0) if forced else str(rng.choice(
            ["run", "run", "over", "eol", "delta", "absolute"]))
        if kind in ("run", "over"):
            k = int(rng.integers(1, w + 1)) if kind == "run" else min(
                255, w - min(x, w) + int(rng.integers(1, 4)))
            k = min(k, 255)
            out += bytes((k, int(rng.integers(0, 256))))
            added = min(k, max(0, w - x))
            n, x = n + added, x + added
        elif kind == "eol":
            out += b"\0\0"
            n, x = n + (-n) % w, 0
        elif kind == "delta":
            right, up = int(rng.integers(0, 3)), int(rng.integers(0, 2))
            out += b"\0\2" + bytes(rng.integers(0, 256, 2, np.uint8)) + bytes(
                (right, up))
            n += right + up * w
            x = n % w
        else:
            k = int(rng.integers(3, 12))
            body = rng.integers(0, 256, k // 2 if rle4 else k, np.uint8)
            out += bytes((0, k)) + body.tobytes()
            n, x = n + (2 * (k // 2) if rle4 else k), x + k
            if (at + len(out)) % 2:
                out += bytes((int(rng.integers(0, 256)),))
    return bytes(out + b"\0\1")


def rle_file(bits: int, w: int, top: bool, pal_kind: str, container: str,
             seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    h = 1 + seed % 4
    n = 16 if bits == 4 else 256
    pal = palette(pal_kind, n, seed)
    gap = 1 if container == "bmp-odd" else 0
    at = 14 + 40 + len(pal) + gap if container != "dib" else 40 + len(pal)
    stream = rle_packets(rng, w, h, bits == 4, at)
    return bmp(w, h, bits, 2 if bits == 4 else 1, stream, pal, top=top,
               gap=gap, dib=container == "dib")


RLE_CASES = [(bits, w, top, pal, container)
             for bits in (8, 4) for w in (1, 2, 3, 4, 5, 6, 7, 8, 9, 33)
             for top in (False, True) for pal in ("grey", "colour")
             for container in ("bmp-even", "bmp-odd", "dib")]


@pytest.mark.parametrize(
    "bits,w,top,pal,container", RLE_CASES,
    ids=[f"rle{b}-w{w}-{'top' if t else 'bottom'}-{p}-{c}"
         for b, w, t, p, c in RLE_CASES])
def test_rle_bmp_and_dib_read_as_jax(bits, w, top, pal, container,
                                     tmp_path):
    seed = RLE_CASES.index((bits, w, top, pal, container))
    data = rle_file(bits, w, top, pal, container, seed)
    ext = ".dib" if container == "dib" else ".bmp"
    rgba = held(tmp_path, "x" + ext, data)
    if pal == "grey" and bits == 4:   # PIL's mode L: the indices themselves
        assert int(rgba[..., 0].max()) < 16


def _rle_edge_cases():
    grey = palette("grey", 256, 0)
    colour = palette("colour", 256, 1)
    grey16 = palette("grey", 16, 0)
    return {
        # (file, PIL reads it)
        "end-of-bitmap-early": (bmp(2, 2, 8, 1, b"\2\5\0\1", grey), False),
        "data-runs-out": (bmp(2, 2, 8, 1, b"\2\5\0\0\1\6", grey), False),
        "two-rows-cut-after-one-run": (bmp(4, 2, 8, 1, b"\4\7", grey), False),
        "too-much-data-cut": (bmp(2, 2, 8, 1, b"\0\4\1\2\3\4\0\3\5\6\7\0",
                                  colour), True),
        "run-cut-at-the-row-then-nothing": (
            bmp(2, 2, 8, 1, b"\2\5\2\6\2\7", grey), False),
        "four-byte-delta": (bmp(12, 3, 8, 1, bytes(
            (0, 2, 1, 0, 2, 1, 6, 9, 0, 0, 12, 8, 0, 0, 12, 3)), colour),
            True),
        "delta-cut-in-its-second-pair": (bmp(3, 3, 8, 1, b"\0\2\1\0\1",
                                             grey), False),
        "delta-cut-in-its-first-pair": (bmp(3, 3, 8, 1, b"\3\1\0\2\1",
                                            grey), False),
        "delta-past-the-end": (bmp(3, 2, 8, 1, bytes(
            (2, 1, 0, 2, 0, 0, 9, 9)), grey), True),
        "absolute-run-into-the-next-row": (
            bmp(3, 2, 8, 1, b"\0\6\1\2\3\4\5\6", colour), True),
        "absolute-run-cut-but-enough": (bmp(2, 2, 8, 1, b"\0\6\1\2\3\4",
                                            colour), True),
        "absolute-run-cut-short": (bmp(2, 2, 8, 1, b"\0\6\1\2\3", colour),
                                   False),
        # 00 05: two bytes, four indices, x moved by 5; the end of line
        # pads the fifth
        "rle4-odd-absolute-drops-a-nibble": (
            bmp(5, 1, 4, 2, b"\0\5\x12\x34\0\0", palette("colour", 16, 2)),
            True),
        # 00 03: one byte, then the padding (the file offset is odd); the
        # run of 2 is cut to the 2 x has left, the end of line pads
        "rle4-odd-absolute-then-run": (
            bmp(5, 1, 4, 2, b"\0\3\x12\0\2\x5a\0\0",
                palette("colour", 16, 2)), True),
        "rle4-odd-absolute-run-not-padded": (
            bmp(5, 1, 4, 2, b"\0\3\x12\2\x5a\0\0",
                palette("colour", 16, 2)), False),
        "rle4-grey-sixteen": (bmp(4, 1, 4, 2, b"\4\x3c", grey16), True),
        "rle4-in-an-8-bit-header": (bmp(4, 1, 8, 2, b"\4\x3c", grey16,
                                        colors=16), True),
        "rle8-in-a-4-bit-header": (bmp(4, 1, 4, 1, b"\4\x3c",
                                       palette("colour", 16, 3)), True),
        "grey-two-entries-mode-1": (bmp(4, 1, 1, 1, b"\4\1",
                                        palette("grey", 2, 0)), False),
        "rle-at-24-bits": (bmp(4, 1, 24, 1, b"\4\1"), False),
        "rle-at-1-bit-colour": (bmp(4, 1, 1, 1, b"\4\1",
                                    palette("colour", 2, 4)), True),
        # PIL's palette read takes the pixels too; they are read again
        # from the file header's offset
        "short-palette": (bmp(4, 1, 8, 1, b"\4\1", colour[:6], colors=256),
                          True),
        "compression-4": (bmp(2, 2, 8, 4, bytes(8), grey), False),
        "compression-5": (bmp(2, 2, 8, 5, bytes(8), grey), False),
        "zero-width": (bmp(0, 2, 8, 1, b"\0\0", grey), False),
    }


RLE_EDGES = _rle_edge_cases()


@pytest.mark.parametrize("case", sorted(RLE_EDGES))
def test_rle_edge_cases_read_as_jax(case, tmp_path):
    data, read = RLE_EDGES[case]
    as_jax(tmp_path, "x.bmp", data)
    assert (jimage.load_rgba(str(tmp_path / "x.bmp")) is not None) == read


def test_the_four_byte_delta_skips_what_its_last_two_bytes_say(tmp_path):
    """``00 02 01 00 09 09``: PIL skips 9 + 9 * width pixels (the last
    two bytes), not 1 (the first two); an end of line pads the tenth row,
    and two rows of 5 follow (a run adds nothing once ``x`` is at the
    row's end: each needs its end of line)."""
    w = 12
    stream = b"\0\2\1\0\11\11" + b"\0\0\14\5" * 2
    rgba = held(tmp_path, "x.bmp", bmp(w, 12, 8, 1, stream,
                                       palette("grey", 256, 0)))
    flat = rgba[::-1, :, 0].ravel()           # PIL's order: bottom row first
    assert not flat[:10 * w].any() and (flat[10 * w:] == 5).all()


# ---- ICO -------------------------------------------------------------------

ICO_SIZES = [(1, 1), (2, 3), (7, 5), (16, 16), (31, 17), (48, 48),
             (256, 256)]
ICO_MODES = ["1", "L", "P", "RGB", "RGBA"]


def mode_image(mode: str, w: int, h: int, seed: int):
    px = np.random.default_rng(seed).integers(0, 256, (h, w, 4), np.uint8)
    px[:, :w // 2] = px[:, :1]
    im = Image.fromarray(px, "RGBA")
    return im.convert("RGB").quantize(11) if mode == "P" else im.convert(
        mode)


@pytest.mark.parametrize("size", ICO_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ICO_MODES)
def test_pil_ico_with_bmp_frames_reads_as_jax(mode, size, tmp_path):
    """PIL's ICO writer with ``bitmap_format="bmp"``: a DIB at the mode's
    bit count (1, 8, 8, 24, 32) and an AND mask of zeros, or at 32 bits
    the alpha in the fourth bytes."""
    im = mode_image(mode, *size, ICO_SIZES.index(size) * 7 + len(mode))
    held(tmp_path, "x.ico", pil_file(im, "ICO", bitmap_format="bmp",
                                     sizes=[size]))


@pytest.mark.parametrize("mode", ICO_MODES)
def test_pil_ico_of_several_sizes_and_depths_reads_as_jax(mode, tmp_path):
    """Thumbnails at 16, 24 and 32, and a 32x32 frame of each other mode
    (another bit count at that size): the sort takes the largest, and of
    frames as large the one of fewer bits."""
    im = mode_image(mode, 32, 32, 3)
    others = [mode_image(m, 32, 32, 4 + i) for i, m in enumerate(ICO_MODES)
              if m != mode]
    data = pil_file(im, "ICO", bitmap_format="bmp",
                    sizes=[(16, 16), (24, 24), (32, 32)],
                    append_images=others)
    rgba = held(tmp_path, "x.ico", data)
    assert rgba.shape == (32, 32, 4)


def dib(w: int, h: int, bits: int, rng, pal: bytes = b"", top=False,
        compression: int = 0, pixels: bytes = None) -> bytes:
    """A BITMAPINFOHEADER at the doubled height ``2 * h``, ``pal``, then
    ``pixels`` or ``h`` rows of random bytes."""
    stride = ((w * bits + 31) >> 3) & ~3
    if pixels is None:
        pixels = rng.integers(0, 256, stride * h, np.uint8).tobytes()
    return struct.pack("<IiiHHIIiiII", 40, w, -2 * h if top else 2 * h, 1,
                       bits, compression, 0, 0, 0, 0, 0) + pal + pixels


def and_mask(w: int, h: int, rng) -> bytes:
    return rng.integers(0, 256, (w + 31) // 32 * 4 * h, np.uint8).tobytes()


def _hand_built_ico():
    rng = np.random.default_rng(21)
    cases = {}
    for bits in (1, 4, 8, 24, 32):
        pal = palette("colour", 1 << bits, bits) if bits <= 8 else b""
        w, h = 13, 9
        frame = dib(w, h, bits, rng, pal)
        mask = and_mask(w, h, rng)
        cases[f"{bits}-bit-with-mask"] = ico_file(
            [(w, h, 0, bits, frame + mask)])
        cases[f"{bits}-bit-entry-says-32"] = ico_file(
            [(w, h, 0, 32, frame + mask)])
        cases[f"{bits}-bit-top-down"] = ico_file(
            [(w, h, 0, bits, dib(w, h, bits, rng, pal, top=True) + mask)])
        cases[f"{bits}-bit-not-the-directory-size"] = ico_file(
            [(40, 3, 0, bits, frame + mask)])
    grey = palette("grey", 256, 0)
    cases["8-bit-grey-palette"] = ico_file(
        [(6, 5, 0, 8, dib(6, 5, 8, rng, grey) + and_mask(6, 5, rng))])
    cases["1-bit-black-white"] = ico_file(
        [(33, 2, 0, 1, dib(33, 2, 1, rng, palette("grey", 2, 0))
          + and_mask(33, 2, rng))])
    frame = dib(10, 4, 24, rng)
    # the mask is read from the end of the entry's resource: junk after it
    # moves it
    mask = and_mask(10, 4, rng)
    cases["mask-before-junk-in-the-resource"] = ico_file(
        [(10, 4, 0, 24, frame + mask + bytes(range(7)))])
    cases["resource-shorter-than-the-dib"] = ico_file(
        [(10, 4, 0, 24, frame + mask)])[:-3]
    # the resource ends 7 bytes short of the mask's end: the mask is read
    # from 7 bytes into the pixels
    cases["mask-cut-short-read-from-the-pixels"] = ico_file(
        [(10, 4, 0, 24, frame + mask[:9])])
    # a resource of 1 byte: the 36-byte mask would start before the file
    tall = dib(10, 9, 24, rng) + and_mask(10, 9, rng)
    cases["mask-before-the-file's-start"] = ico_file(
        [(10, 9, 0, 24, tall)]).replace(struct.pack("<II", len(tall), 22),
                                        struct.pack("<II", 1, 22))
    cases["32-bit-alpha-cut-short"] = ico_file(
        [(10, 4, 0, 32, dib(10, 4, 32, rng)[:-5])])
    rle = (b"\12\3\0\0" * 4) + and_mask(10, 4, rng)
    cases["rle8-frame"] = ico_file(
        [(10, 4, 0, 8, dib(10, 4, 8, rng, palette("colour", 256, 5),
                           compression=1, pixels=rle))])
    cases["one-row-dib"] = ico_file(
        [(3, 1, 0, 24, struct.pack("<IiiHHIIiiII", 40, 3, 1, 1, 24, 0, 0, 0,
                                   0, 0, 0) + bytes(16))])
    cases["largest-of-a-png-and-a-dib"] = ico_file(
        [(8, 8, 0, 32, pil_file(mode_image("RGB", 8, 8, 1), "PNG")),
         (12, 12, 0, 24, dib(12, 12, 24, rng) + and_mask(12, 12, rng))])
    return cases


ICO_HAND = _hand_built_ico()


@pytest.mark.parametrize("case", sorted(ICO_HAND))
def test_hand_built_ico_frames_read_as_jax(case, tmp_path):
    as_jax(tmp_path, "x.ico", ICO_HAND[case])


def test_hand_built_ico_cases_are_read_by_pil_where_named(tmp_path):
    # an entry of 32 bits over a DIB of fewer has too few bytes for the
    # alpha PIL reads
    failing = {"32-bit-alpha-cut-short", "one-row-dib",
               "resource-shorter-than-the-dib",
               "mask-before-the-file's-start"} | {
                   f"{bits}-bit-entry-says-32" for bits in (1, 4, 8, 24)}
    for case, data in ICO_HAND.items():
        path = tmp_path / f"{case}.ico"
        path.write_bytes(data)
        assert (jimage.load_rgba(str(path)) is None) == (case in failing), \
            case


ICNS_PNG_TYPES = {b"ic07": 128, b"ic08": 256, b"ic09": 512, b"ic11": 32,
                  b"ic12": 64, b"icp4": 16, b"icp5": 32, b"icp6": 64}


@pytest.mark.parametrize("seed", range(4))
def test_png_frames_of_other_sizes_read_as_jax(seed, tmp_path):
    """The PNG frames and entries the readers took before this slice, 25
    ICOs and 25 ICNS files a seed: frames of any size under directory
    sizes that are not theirs (PIL warns and takes the frame's), of
    modes RGB, L, RGBA, P, 1 and LA, colour counts and bit counts that
    change the sort; entries at their type's size, half, double, a
    quarter or another, checked by PIL's ``size`` setter."""
    rng = np.random.default_rng(200 + seed)
    modes = ["RGB", "L", "RGBA", "P", "1", "LA"]
    for _ in range(25):
        frames = []
        for _ in range(int(rng.integers(1, 4))):
            w, h = int(rng.integers(1, 70)), int(rng.integers(1, 70))
            mode = modes[int(rng.integers(0, len(modes)))]
            dw, dh = (w, h) if rng.random() < 0.5 else (
                int(rng.integers(0, 256)), int(rng.integers(0, 256)))
            frames.append((dw, dh, int(rng.choice([0, 0, 2, 16])),
                           int(rng.choice([0, 8, 24, 32])),
                           pil_file(mode_image(mode, w, h, seed), "PNG")))
        as_jax(tmp_path, "x.ico", ico_file(frames))
        blocks = []
        for _ in range(int(rng.integers(1, 3))):
            kind = sorted(ICNS_PNG_TYPES)[int(rng.integers(0, 8))]
            side = ICNS_PNG_TYPES[kind]
            w = int(rng.choice([side, side // 2, side * 2, side // 4,
                                int(rng.integers(1, 80))])) or 1
            h = w if rng.random() < 0.8 else int(rng.integers(1, 80))
            mode = modes[int(rng.integers(0, 4))]
            blocks.append(block(kind, pil_file(mode_image(
                mode, min(w, 600), min(h, 600), seed), "PNG")))
        as_jax(tmp_path, "x.icns", icns_file(*blocks))


# ---- CUR -------------------------------------------------------------------

def cur_file(entries, offset=None) -> bytes:
    """A CUR of ``(width byte, height byte, bitmap)`` entries, each bitmap
    at its offset after the directory (or all at ``offset``)."""
    out = b"\0\0\2\0" + struct.pack("<H", len(entries))
    at = 6 + 16 * len(entries)
    body = b""
    for w, h, bitmap in entries:
        out += struct.pack("<BBBBHHII", w, h, 0, 0, 1, 2, len(bitmap),
                           at + len(body) if offset is None else offset)
        body += bitmap
    return out + body


def _cur_cases():
    rng = np.random.default_rng(31)
    d24, d32 = dib(9, 7, 24, rng), dib(9, 7, 32, rng)
    small = dib(4, 3, 24, rng)
    return {
        "one-24-bit": cur_file([(9, 7, d24)]),
        "one-32-bit-at-byte-22-keeps-alpha": cur_file([(9, 7, d32)]),
        "two-32-bit-drops-alpha": cur_file([(9, 7, d32), (4, 3, small)]),
        "second-larger-both-ways": cur_file([(4, 3, small), (9, 7, d32)]),
        "second-larger-one-way": cur_file([(4, 3, small), (9, 2, d24)]),
        "second-as-large": cur_file([(9, 7, d24), (9, 7, small)]),
        "8-bit-palette": cur_file([(6, 4, dib(6, 4, 8, rng, palette(
            "colour", 256, 6)))]),
        "1-bit": cur_file([(32, 32, dib(32, 32, 1, rng, palette(
            "grey", 2, 0)))]),
        "rle8": cur_file([(4, 2, dib(4, 2, 8, rng, palette(
            "colour", 256, 7), compression=1, pixels=b"\4\1\4\2"))]),
        "offset-0-reads-after-the-directory": cur_file([(9, 7, d24)],
                                                       offset=0),
        "one-row-bitmap": cur_file([(3, 1, struct.pack(
            "<IiiHHIIiiII", 40, 3, 1, 1, 24, 0, 0, 0, 0, 0, 0) + bytes(16))]),
        "bitmap-past-the-end": cur_file([(9, 7, d24)], offset=9999),
        "pixels-cut-short": cur_file([(9, 7, d24[:-30])]),
    }


CUR_CASES = _cur_cases()


@pytest.mark.parametrize("case", sorted(CUR_CASES))
def test_cur_reads_as_jax(case, tmp_path):
    as_jax(tmp_path, "x.cur", CUR_CASES[case])


def test_cur_alpha_only_at_byte_22(tmp_path):
    kept = held(tmp_path, "a.cur",
                CUR_CASES["one-32-bit-at-byte-22-keeps-alpha"])
    dropped = held(tmp_path, "b.cur", CUR_CASES["two-32-bit-drops-alpha"])
    assert (kept[..., 3] != 255).any() and (dropped[..., 3] == 255).all()
    np.testing.assert_array_equal(kept[..., :3], dropped[..., :3])


# ---- ICNS ------------------------------------------------------------------

ICNS_RLE = {b"is32": (16, b"s8mk"), b"il32": (32, b"l8mk"),
            b"ih32": (48, b"h8mk"), b"it32": (128, b"t8mk")}


def icns_rgb(side: int, seed: int) -> np.ndarray:
    px = np.random.default_rng(seed).integers(0, 256, (side, side, 3),
                                              np.uint8)
    px[:, :side // 2] = px[:, :1] // 5 * 5
    return px


@pytest.mark.parametrize("coding", ["rle", "raw"])
@pytest.mark.parametrize("mask", [True, False], ids=["mask", "no-mask"])
@pytest.mark.parametrize("kind", sorted(ICNS_RLE), ids=bytes.decode)
def test_icns_rle_entries_read_as_jax(kind, mask, coding, tmp_path):
    side, mask_kind = ICNS_RLE[kind]
    px = icns_rgb(side, side)
    body = (b"".join(fx.icns_rle(px[..., c]) for c in range(3))
            if coding == "rle" else px.tobytes())
    if kind == b"it32":
        body = bytes(4) + body
    blocks = [block(kind, body)]
    if mask:
        blocks.append(block(mask_kind, icns_rgb(side, 1)[..., 0].tobytes()))
    rgba = held(tmp_path, "x.icns", icns_file(*blocks))
    # uncompressed at exactly 3 w h: PIL's "RGB" rawmode, interleaved
    np.testing.assert_array_equal(rgba[..., :3], px)
    assert (rgba[..., 3] == 255).all() != mask


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("codec", ["jp2", "j2k"])
@pytest.mark.parametrize("kind", [b"ic08", b"ic09"], ids=bytes.decode)
def test_icns_jpeg2000_entries_read_as_jax(kind, codec, mode, tmp_path):
    """PIL's JPEG 2000 writer at its defaults (a JP2 file, or a
    codestream with ``no_jp2``), at the entry's size."""
    side = 256 if kind == b"ic08" else 512
    im = mode_image(mode, side, side, side + len(mode))
    stream = pil_file(im, "JPEG2000", no_jp2=codec == "j2k")
    held(tmp_path, "x.icns", icns_file(block(kind, stream)))


def _icns_cases():
    px = icns_rgb(16, 2)
    rle = b"".join(fx.icns_rle(px[..., c]) for c in range(3))
    mask = icns_rgb(16, 3)[..., 0].tobytes()
    png16 = pil_file(Image.fromarray(icns_rgb(16, 4)), "PNG")
    j2k = pil_file(Image.fromarray(icns_rgb(32, 5)), "JPEG2000", no_jp2=True)
    return {
        "png-wins-over-rle": icns_file(block(b"is32", rle),
                                       block(b"icp4", png16)),
        "bad-rle-fails-the-png-too": icns_file(block(b"icp4", png16),
                                               block(b"is32", rle[:-4])),
        "mask-alone": icns_file(block(b"s8mk", mask)),
        "mask-cut-short": icns_file(block(b"is32", rle),
                                    block(b"s8mk", mask[:-1])),
        "mask-reads-on-past-its-entry": icns_file(
            block(b"s8mk", mask[:100]), block(b"abcd", mask[100:]),
            block(b"is32", rle)),
        # the entry, last in the file's length, holds 20 bytes of its
        # packets; the rest follow past the length
        "rle-reads-on-past-its-entry": icns_file(
            block(b"is32", rle[:20])) + rle[20:],
        "packets-after-the-third-plane": icns_file(block(
            b"is32", rle + b"\x80\1")),
        "run-past-the-plane": icns_file(block(b"is32", b"\xff\1\xff\2" * 3)),
        "raw-length-short": icns_file(block(b"is32", px.tobytes()[:-1])),
        "it32-without-its-zero-bytes": icns_file(block(b"it32", b"\0\0\0\1"
                                                       + bytes(300))),
        "it32-zero-bytes-then-nothing": icns_file(block(b"it32", bytes(4))),
        "j2k-of-another-size-fails-the-size-check": icns_file(
            block(b"ic08", pil_file(Image.fromarray(icns_rgb(100, 6)),
                                    "JPEG2000", no_jp2=True))),
        "j2k-a-quarter-of-the-entry": icns_file(block(b"ic07", j2k)),
        "j2k-read-to-its-entry's-length-only": icns_file(
            block(b"ic07", j2k[:-9]), block(b"abcd", j2k[-9:])),
        "bare-jp2-signature-box": icns_file(block(
            b"ic07", b"\x0d\x0a\x87\x0a" + bytes(40))),
        "jp2-signature-then-junk": icns_file(block(
            b"ic08", b"\0\0\0\x0cjP  \x0d\x0a\x87\x0a" + bytes(64))),
    }


ICNS_CASES = _icns_cases()


@pytest.mark.parametrize("case", sorted(ICNS_CASES))
def test_icns_entries_read_as_jax(case, tmp_path):
    as_jax(tmp_path, "x.icns", ICNS_CASES[case])


def test_icns_cases_are_read_by_pil_where_named(tmp_path):
    reads = {"png-wins-over-rle", "mask-reads-on-past-its-entry",
             "rle-reads-on-past-its-entry", "j2k-a-quarter-of-the-entry",
             "packets-after-the-third-plane"}
    for case, data in ICNS_CASES.items():
        path = tmp_path / f"{case}.icns"
        path.write_bytes(data)
        assert (jimage.load_rgba(str(path)) is not None) == (case in reads), \
            case


# ---- files once refused -----------------------------------------------------

def _once_refused():
    """The files the port refused before it read these flavours (the cases
    of ``tests/test_torch_formats.py::_refused`` and
    ``tests/test_torch_pdf_ico_icns.py`` they replace)."""
    x = ti.smooth_rgb(4, 16, 16)
    cases = {
        "RLE BMP": ti.bmp_bytes(4, 2, 8, [bytes(4)] * 2,
                                palette=bytes(1024), compression=1),
        "RLE DIB": ti.bmp_bytes(4, 2, 8, [bytes(4)] * 2,
                                palette=bytes(1024), compression=1)[14:],
        "4-bit RLE DIB": ti.bmp_bytes(4, 2, 4, [bytes(2)] * 2,
                                      palette=bytes(64), compression=2)[14:],
        "ICO writer": pil_file(Image.fromarray(x), "ICO",
                               bitmap_format="bmp"),
        "it32": icns_file(block(b"it32", bytes(4) + bytes(3 * 128 * 128)),
                          block(b"ic11", pil_file(Image.fromarray(
                              ti.smooth_rgb(1, 32, 32, noise=40)), "PNG"))),
        "t8mk": icns_file(block(b"t8mk", bytes(128 * 128)),
                          block(b"ic11", pil_file(Image.fromarray(
                              ti.smooth_rgb(1, 32, 32, noise=40)), "PNG"))),
    }
    for mode in ("RGB", "L"):
        px = ti.smooth_rgb(4, 40, 30, noise=40)
        cases[f"ICO writer {mode} 40x30"] = pil_file(
            Image.fromarray(px[..., 1] if mode == "L" else px), "ICO",
            bitmap_format="bmp")
    return cases


ONCE_REFUSED = _once_refused()


@pytest.mark.parametrize("case", sorted(ONCE_REFUSED))
def test_files_once_refused_read_as_jax(case, tmp_path):
    """Read as the JAX package reads them (the RLE files of zeros are
    PIL's "not enough image data": None; the ``t8mk`` entry alone at the
    best size is a mask without its RGB: None)."""
    as_jax(tmp_path, "x.bin", ONCE_REFUSED[case])


# ---- every cut, damaged data ------------------------------------------------

def small_files():
    rng = np.random.default_rng(41)
    index = np.repeat(rng.integers(0, 256, (5, 3)), 3, 1)[:, :9]
    index[2, 4:] = rng.integers(0, 256, 5)
    px = icns_rgb(16, 7)
    return {
        "rle8.bmp": fx.bmp_rle8_bytes(index.astype(np.uint8), rng.integers(
            0, 256, (256, 3), np.uint8)),
        "rle4.dib": bmp(7, 4, 4, 2, rle_packets(rng, 7, 4, True, 40 + 64),
                        palette("colour", 16, 8), dib=True),
        "dib-frame.ico": fx.ico_dib_bytes(icns_rgb(12, 9),
                                          rng.random((12, 12)) < 0.3),
        "cursor.cur": fx.cur_bytes(rng.integers(0, 256, (8, 8, 4),
                                                np.uint8)),
        "rle.icns": fx.icns_bytes((b"is32", b"".join(
            fx.icns_rle(px[..., c]) for c in range(3))),
            (b"s8mk", icns_rgb(16, 10)[..., 0].tobytes())),
    }


SMALL = small_files()


@pytest.mark.parametrize("name", sorted(SMALL))
def test_every_cut_reads_as_jax(name, tmp_path):
    """Every length from 0 to the file's: None exactly where the JAX
    package is None (a cut that keeps every pixel PIL needs reads)."""
    data = SMALL[name]
    assert jimage.load_rgba(str(_write(tmp_path, name, data))) is not None
    read = 0
    for n in range(len(data) + 1):
        path = _write(tmp_path, name, data[:n])
        want = jimage.load_rgba(str(path))
        got = image.load_rgba(str(path))
        assert (got is None) == (want is None), n
        if want is not None:
            np.testing.assert_array_equal(got.view(np.int32),
                                          want.view(np.int32), err_msg=n)
            read += 1
    assert read >= 1


def _write(tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    return path


# where each small file's pixel data starts (what is damaged)
PIXELS_AT = {"rle8.bmp": 14 + 40 + 1024, "rle4.dib": 40 + 64,
             "dib-frame.ico": 22 + 40, "cursor.cur": 22 + 40,
             "rle.icns": 8 + 8 + 16 + 8}


@pytest.mark.parametrize("seed", range(8))
def test_damaged_pixel_data_reads_as_jax(seed, tmp_path):
    """25 files a seed, 200 in all: 1-3 bytes of a small file's pixel
    data (packets, pixels, mask) replaced."""
    rng = np.random.default_rng(100 + seed)
    names = sorted(SMALL)
    for i in range(25):
        name = names[(seed * 25 + i) % len(names)]
        data = bytearray(SMALL[name])
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(PIXELS_AT[name], len(data)))] = int(
                rng.integers(0, 256))
        as_jax(tmp_path, name, bytes(data))


# ---- the reader maps --------------------------------------------------------

NEW_MAPS = ("roughness_2048_rle8.bmp", "normal_256_dib.ico",
            "rle8_3840x2160.bmp", "cursor_256.cur", "icon_128_it32.icns",
            "icon_512_jp2.icns")


@pytest.mark.parametrize("name", NEW_MAPS)
def test_reader_map_files_decode_to_recorded_digests(name, tmp_path):
    """The encoders' files (the JP2 entry PIL's, and the port's byte for
    byte) decode, through the JAX package, to the digest
    ``tests/torch_data/map_digests.json`` records, which ``chip_smoke.py``
    holds the card machine's decode to."""
    with open(os.path.join(REPO, "tests", "torch_data",
                           "map_digests.json")) as f:
        want = json.load(f)[name]
    px, data = fx.reader_map(name, lambda px: pil_file(
        Image.fromarray(px), "JPEG2000"))
    _, port_data = fx.reader_map(name, lambda px: jpeg2000.encode(px, "jp2"))
    assert port_data == data
    assert hashlib.sha256(data).hexdigest() == want["file_sha256"]
    path = _write(tmp_path, name, data)
    rgba = np.round(jimage.load_rgba(str(path)) * 255).astype(np.uint8)
    assert list(rgba.shape) == want["shape"]
    assert hashlib.sha256(rgba.tobytes()).hexdigest() == want["rgba_sha256"]
    np.testing.assert_array_equal(rgba[..., :3], px)
    np.testing.assert_array_equal(image.load_rgba8(str(path)), rgba)


# ---- scenes ----------------------------------------------------------------

def bmp_ico_maps(tmp_path):
    """Paths of an RLE8 BMP roughness map (grey, 40x24) and an ICO normal
    map (a 24-bit DIB with an AND mask, 32x32)."""
    rough = tmp_path / "rough.bmp"
    rough.write_bytes(fx.bmp_rle8_bytes(fx.procedural_rgb(40, 24, 5)[..., 0]))
    normal = tmp_path / "normal.ico"
    normal.write_bytes(fx.ico_dib_bytes(fx.normal_map(32, 2),
                                        fx.procedural_rgb(32, 32, 6)[..., 2]
                                        > 200))
    return str(rough), str(normal)


def test_compile_with_rle_bmp_and_ico_maps_equals_jax(tmp_path):
    rough, normal = bmp_ico_maps(tmp_path)
    jsc = cornell_scene(depth=2, res=(16, 16),
                        block_types=(MaterialType.GLOSSY, MaterialType.GLOSSY))
    jsc.set_roughness_texture(0, 6, rough)
    jsc.set_roughness_texture(0, 7, rough)
    jsc.set_normal_texture(0, 3, normal)
    got = to_port_scene(jsc).compile("cpu", build_bvh=False)
    assert got.textures.shape == (2, 32, 40, 4)
    assert_fields_equal(jsc.compile(build_bvh=False), got)


def test_rle_bmp_and_ico_mapped_trace_matches_jax_under_one_key(tmp_path):
    """The glossy wall of ``normal_mapped_wall`` with the RLE8 BMP
    roughness map and the ICO normal map (rtol 1e-4 / atol 1e-6)."""
    rough, normal = bmp_ico_maps(tmp_path)
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    got, want = trace_both(jsc, jsc.trace_depth, 5, False)
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


_NO_JAX_BMP_ICONS = r"""
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
from pathtracing_spectrum_tpu_torch.utils import image, jpeg2000

spec = importlib.util.spec_from_file_location(
    "fx", os.path.join(sys.argv[1], "tools", "make_torch_fixtures.py"))
fx = importlib.util.module_from_spec(spec)
spec.loader.exec_module(fx)
tmp, assets = sys.argv[2], os.path.join(sys.argv[1], "assets")
paths = {}
for name, data in (
        ("r.bmp", fx.bmp_rle8_bytes(fx.procedural_rgb(40, 24, 3)[..., 1])),
        ("n.ico", fx.ico_dib_bytes(fx.procedural_rgb(32, 32, 4),
                                   np.eye(32, dtype=bool))),
        ("c.cur", fx.cur_bytes(fx.procedural_rgb(16, 16, 5)[..., [0, 1, 2,
                                                                  0]])),
        ("i.icns", fx.icns_bytes((b"il32", b"".join(fx.icns_rle(
            fx.procedural_rgb(32, 32, 6)[..., c]) for c in range(3))))),
        ("j.icns", fx.icns_bytes((b"ic08", jpeg2000.encode(
            fx.procedural_rgb(256, 256, 7), "j2k"))))):
    paths[name] = os.path.join(tmp, name)
    with open(paths[name], "wb") as f:
        f.write(data)
    assert image.load_rgba8(paths[name]) is not None, name
sc = pt.Scene()
sc.wavelengths = [500.0, 1000.0, 1500.0, 2000.0]
sc.spectrum_materials = [pt.SpectrumMaterial("body", [0.7, 0.75, 0.8, 0.7]),
                         pt.SpectrumMaterial("emitter", [1.0] * 4)]
sc.resolution = (12, 8)
obj = sc.load_object(os.path.join(assets, "sphere.obj"))
sc.set_material(0, 0, pt.Material(
    type=pt.MaterialType.GLOSSY, spectrum_mat_id=0, temperature=80.0,
    roughness=0.4, roughness_tex_file=paths["r.bmp"]))
sc.set_normal_texture(0, 0, paths["n.ico"])
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


def test_bmp_and_icon_mapped_render_imports_neither_jax_nor_pil(tmp_path):
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_BMP_ICONS, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
