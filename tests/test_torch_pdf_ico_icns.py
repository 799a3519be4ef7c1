"""The port's PDF, ICO and ICNS writers, its ICO and ICNS readers and the
resampler under them against the JAX package (PIL 12.1), exact
everywhere (tolerance 0: bytes, pixels, and ``load_rgba`` as an int32
view), apart from the mapped trace's rtol 1e-4 / atol 1e-6, as
``tests/test_torch_spectral.py`` states it.

- The resampler (``utils/resample.py``, ``csrc/resample.cpp``): byte for
  byte ``Image.resize`` under LANCZOS and BICUBIC, L and RGB, every
  target side 1-64 (square, and wide or tall to 65 in all) from sources
  that are square, wide, tall, one pixel, up- and downscaled;
  ``Image.thumbnail``'s size rule and pixels (``reducing_gap=None``).
- PDF byte for byte under a pinned ``time.gmtime`` at the sizes of
  ``test_write_image_is_pils_file_byte_for_byte``, both modes, stems
  with parentheses, a backslash, a non-ASCII letter and a character
  whose UTF-16 holds ``(`` and ``)``; the two dates from two calls, as
  PIL makes them; a stem PIL cannot encode raising PIL's exception.
- ICO and ICNS: the directory equal to PIL's with lengths and offsets
  left out, each payload a PNG whose mode and pixels equal PIL's frame,
  decoded by PIL and by the port, from 0x0 to 300x260 images.
- Reading: PIL's and the port's files, hand-made ICOs (frames of several
  sizes, two of one size, colour counts, PNG modes with ``tRNS``, a size
  that is not the directory's, damaged directories) and ICNS files (each
  PNG size, blocks out of order or repeated, JPEG 2000 entries of junk,
  damaged blocks) equal to the JAX package's ``load_rgba``, None where it
  is None (BMP frames and RLE, mask and JPEG 2000 entries:
  ``tests/test_torch_bmp_icons.py``).
- A scene with an ICNS roughness map and an ICO normal map compiled and
  traced against the JAX package, and a render from those maps in a
  process that refuses to import jax and PIL.
"""

import io
import os
import struct
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from pathtracing_spectrum_tpu import MaterialType  # noqa: E402
from pathtracing_spectrum_tpu.utils import image as jimage  # noqa: E402
from pathtracing_spectrum_tpu_torch import _build  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import image, resample  # noqa: E402

import torch_images as ti  # noqa: E402
from scene_helpers import cornell_scene  # noqa: E402
from test_torch_readers import as_jax, held, pil_file  # noqa: E402
from test_torch_scene import assert_fields_equal, to_port_scene  # noqa: E402,E501
from test_torch_spectral import assert_same, trace_both  # noqa: E402
from test_torch_textures import normal_mapped_wall  # noqa: E402
from test_torch_qoi_dds import REPO, fx  # noqa: E402

FILTERS = {"lanczos": (resample.LANCZOS, Image.Resampling.LANCZOS),
           "bicubic": (resample.BICUBIC, Image.Resampling.BICUBIC)}


def pixels(w: int, h: int, mode: str, seed: int) -> np.ndarray:
    """Smooth content with noise (both filters' negative lobes clip)."""
    px = ti.smooth_rgb(seed, w, h, noise=40)
    return np.ascontiguousarray(px[..., 1]) if mode == "L" else px


# ---- the resampler ---------------------------------------------------------

@pytest.mark.parametrize("source", [(37, 29), (64, 64), (1, 1), (300, 20),
                                    (20, 300), (97, 131)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("name", sorted(FILTERS))
def test_resize_is_pils_byte_for_byte(name, mode, source):
    """Every target side 1-64, as a square and as a side paired with 65
    minus it (wide and tall), from each source."""
    ours, pils = FILTERS[name]
    img = pixels(*source, mode, sum(source))
    pil = Image.fromarray(img)
    for side in range(1, 65):
        for size in ((side, side), (side, 65 - side)):
            want = np.asarray(pil.resize(size, pils))
            got = resample.resize(img, size, ours)
            assert got.shape == want.shape and np.array_equal(got, want), \
                (name, mode, source, size)


def test_resize_to_its_own_size_is_a_copy():
    img = pixels(7, 5, "RGB", 1)
    got = resample.resize(img, (7, 5), resample.LANCZOS)
    assert np.array_equal(got, img) and got is not img


@pytest.mark.parametrize("source", [(37, 29), (3840, 2160), (300, 20),
                                    (20, 300), (16, 16), (257, 256),
                                    (1000, 999)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_thumbnail_size_is_pils(source):
    """``preserve_aspect_ratio`` into every ICO square, against the size
    PIL's ``thumbnail`` leaves (37x29 into 16: 16x13; 3840x2160 into 256:
    256x144)."""
    w, h = source
    for side in (1, 2, 16, 24, 32, 48, 64, 128, 256):
        pil = Image.new("L", (w, h))
        pil.thumbnail((side, side), Image.Resampling.NEAREST)
        got = resample.thumbnail_size(w, h, (side, side))
        assert (got or (w, h)) == pil.size, (source, side)
    assert resample.thumbnail_size(37, 29, (16, 16)) == (16, 13)
    assert resample.thumbnail_size(3840, 2160, (256, 256)) == (256, 144)


@pytest.mark.parametrize("source", [(37, 29), (300, 20), (20, 300),
                                    (64, 64), (130, 257)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_lanczos_thumbnail_is_pils(mode, source):
    img = pixels(*source, mode, 5)
    for side in (16, 24, 32, 48, 64, 128, 256):
        pil = Image.fromarray(img)
        pil.thumbnail((side, side), Image.Resampling.LANCZOS,
                      reducing_gap=None)
        assert np.array_equal(resample.thumbnail(
            img, (side, side), resample.LANCZOS), np.asarray(pil)), side


def test_resampler_has_no_python_fallback(monkeypatch, tmp_path):
    """Where the host library cannot be built, the ICO and ICNS writers
    raise the build's error and write nothing."""
    def broken():
        raise RuntimeError("build failed")
    monkeypatch.setattr(_build, "load_host", broken)
    for ext in (".ico", ".icns"):
        path = tmp_path / f"x{ext}"
        with pytest.raises(RuntimeError, match="build failed"):
            image.write_image(str(path), np.zeros((20, 20, 3), np.uint8))
        assert not path.exists()


# ---- PDF -------------------------------------------------------------------

# the sizes of test_torch_image_write.py's byte-for-byte test
SIZES = [(1, 1), (17, 9), (37, 29), (45, 53)]
STEMS = {"plain": "x", "odd": "a (b)\\c é",
         "utf16-parentheses": "t⠩"}


def save_both(tmp_path, px, name: str):
    """(the port's file, PIL's file) of ``px`` as ``name`` in two
    folders."""
    out = []
    for who, save in (("port", image.write_image),
                      ("pil", lambda p, x: Image.fromarray(x).save(p))):
        folder = tmp_path / who
        folder.mkdir(exist_ok=True)
        save(str(folder / name), px)
        out.append((folder / name).read_bytes())
    return out


@pytest.mark.parametrize("stem", sorted(STEMS))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_pdf_is_pils_byte_for_byte(mode, size, stem, tmp_path):
    px = pixels(*size, mode, size[0] * size[1])
    with fx.pinned_gmtime():
        port, pil = save_both(tmp_path, px, STEMS[stem] + ".pdf")
    assert port == pil
    assert port.startswith(b"%PDF-1.4\n% created by Pillow PDF driver\n")


def test_pdf_dates_are_two_readings_of_gmtime(monkeypatch, tmp_path):
    """PIL reads ``time.gmtime()`` twice, the creation date first; the
    port reads it at the same points."""
    times = [time.struct_time((2001, 2, 3, 4, 5, 6, 5, 34, 0)),
             time.struct_time((2009, 8, 7, 6, 5, 4, 4, 219, 0))]
    files = []
    for who, save in (("port", image.write_image),
                      ("pil", lambda p, x: Image.fromarray(x).save(p))):
        readings = iter(times)
        monkeypatch.setattr(time, "gmtime", lambda *a: next(readings))
        (tmp_path / who).mkdir()
        save(str(tmp_path / who / "x.pdf"), pixels(9, 7, "RGB", 2))
        monkeypatch.undo()
        files.append((tmp_path / who / "x.pdf").read_bytes())
    assert files[0] == files[1]
    assert b"/CreationDate (D:20010203040506Z)\n/ModDate (D:20090807060504Z)" \
        in files[0]


def test_pdf_stem_pil_cannot_encode_raises_pils_error(tmp_path):
    px = np.zeros((2, 3), np.uint8)
    errors = []
    for who, save in (("port", image.write_image),
                      ("pil", lambda p, x: Image.fromarray(x).save(p))):
        (tmp_path / who).mkdir()
        path = tmp_path / who / "stem\udcff.pdf"
        with pytest.raises(UnicodeEncodeError) as e:
            save(str(path), px)
        assert not path.exists()
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("shape", [(0, 3), (3, 0, 3)])
@pytest.mark.parametrize("ext", [".pdf", ".jpg"])
def test_empty_image_raises_pils_jpeg_error(ext, shape, tmp_path):
    """PIL's JPEG writer refuses an empty image (the port's JPEG encoder
    once wrote a file for it, or crashed)."""
    px = np.zeros(shape, np.uint8)
    with pytest.raises(ValueError) as want:
        Image.fromarray(px).save(str(tmp_path / f"pil{ext}"))
    with pytest.raises(ValueError) as got:
        image.write_image(str(tmp_path / f"port{ext}"), px)
    assert str(got.value) == str(want.value)
    assert not (tmp_path / f"port{ext}").exists()


# ---- ICO and ICNS, written -------------------------------------------------

def ico_parts(data: bytes):
    """(header, [(entry without length and offset, payload)])."""
    n = struct.unpack_from("<H", data, 4)[0]
    out = []
    for i in range(n):
        entry = data[6 + 16 * i:22 + 16 * i]
        length, offset = struct.unpack_from("<II", entry, 8)
        out.append((entry[:8], data[offset:offset + length]))
    return data[:6], out


def icns_parts(data: bytes):
    """(the table of contents' types, [(type, payload)])."""
    out, pos, toc = [], 8, None
    assert struct.unpack_from(">I", data, 4)[0] == len(data)
    while pos < len(data):
        kind, length = struct.unpack_from(">4sI", data, pos)
        body = data[pos + 8:pos + length]
        if kind == b"TOC ":
            toc = [body[i:i + 4] for i in range(0, len(body), 8)]
            lengths = [struct.unpack_from(">I", body, i + 4)[0]
                       for i in range(0, len(body), 8)]
        else:
            out.append((kind, body))
        pos += length
    assert lengths == [8 + len(body) for _, body in out]
    return toc, out


def frame_pixels(png: bytes):
    with Image.open(io.BytesIO(png)) as im:
        assert im.format == "PNG"
        return im.mode, np.asarray(im)


ICON_SIZES = [(0, 0), (1, 1), (15, 15), (16, 16), (37, 29), (300, 20),
              (20, 300), (300, 260)]


@pytest.mark.parametrize("size", ICON_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("ext", [".ico", ".icns"])
def test_icon_is_pils_frame_for_frame(ext, mode, size, tmp_path):
    """The directory PIL's (lengths and offsets left out); each payload a
    PNG of PIL's mode and pixels, decoded by PIL and by the port."""
    w, h = size
    px = pixels(max(w, 1), max(h, 1), mode, w + h)[:h, :w]
    port, pil = save_both(tmp_path, np.ascontiguousarray(px), "x" + ext)
    parts = ico_parts if ext == ".ico" else icns_parts
    (port_head, port_frames), (pil_head, pil_frames) = parts(port), parts(pil)
    assert port_head == pil_head
    assert [e for e, _ in port_frames] == [e for e, _ in pil_frames]
    if ext == ".ico":
        assert len(port) == 6 + sum(16 + len(f) for _, f in port_frames)
    for (_, ours), (_, theirs) in zip(port_frames, pil_frames):
        mode_got, got = frame_pixels(ours)
        mode_want, want = frame_pixels(theirs)
        assert mode_got == mode_want == mode
        assert np.array_equal(got, want)
        assert np.array_equal(image._decode_png(ours),
                              np.asarray(Image.open(io.BytesIO(
                                  theirs)).convert("RGBA")))


def test_icns_shares_pils_pngs_and_ico_counts_its_frames(tmp_path):
    """``ic08``/``ic13`` and ``ic09``/``ic14`` hold one PNG each; an ICO of
    an image under 16 pixels a side is PIL's 6-byte file; a 256-pixel
    frame is entered as 0."""
    port, pil = save_both(tmp_path, pixels(300, 260, "RGB", 3), "x.icns")
    frames = dict(icns_parts(port)[1])
    assert frames[b"ic08"] == frames[b"ic13"]
    assert frames[b"ic09"] == frames[b"ic14"]
    port, pil = save_both(tmp_path, pixels(15, 40, "L", 3), "x.ico")
    assert port == pil == b"\0\0\1\0\0\0"
    port, _ = save_both(tmp_path, pixels(300, 260, "L", 3), "x.ico")
    entries = [e for e, _ in ico_parts(port)[1]]
    assert [e[0] for e in entries] == [16, 24, 32, 48, 64, 128, 0]
    assert entries[-1][1] == 222


# ---- ICO and ICNS, read ----------------------------------------------------

@pytest.mark.parametrize("size", [(1, 1), (16, 16), (37, 29), (300, 20),
                                  (20, 300)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", ["L", "RGB"])
@pytest.mark.parametrize("ext", [".ico", ".icns"])
def test_written_icons_read_as_jax(ext, mode, size, tmp_path):
    """PIL's file and the port's read in the port as the JAX package reads
    them (an ICO under 16 pixels has no frame: None in both)."""
    px = pixels(*size, mode, size[0] * 3 + size[1])
    port, pil = save_both(tmp_path, px, "x" + ext)
    for who, data in (("port", port), ("pil", pil)):
        as_jax(tmp_path, f"{who}{ext}", data)
    want = jimage.load_rgba(str(tmp_path / "pil" / f"x{ext}"))
    assert (want is None) == (ext == ".ico" and min(size) < 16)


def png(px, mode: str | None = None, **save) -> bytes:
    return pil_file(Image.fromarray(px) if mode is None
                    else Image.fromarray(px).convert(mode), "PNG", **save)


def ico_file(frames) -> bytes:
    """An ICO of ``(width, height, colours, bits, payload)`` frames, each
    at its offset after the directory (width and height 256 as 0)."""
    out = b"\0\0\1\0" + struct.pack("<H", len(frames))
    offset = 6 + 16 * len(frames)
    body = b""
    for w, h, colours, bits, payload in frames:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, colours, 0, 1,
                           bits, len(payload), offset + len(body))
        body += payload
    return out + body


def _ico_cases():
    rgb = pixels(24, 18, "RGB", 7)
    small, grey = rgb[:9, :12], rgb[..., 0].copy()
    p = Image.fromarray(rgb).quantize(5)
    trns_p = pil_file(p, "PNG", transparency=bytes([0, 90, 255, 7]))
    trns_l = png(grey, transparency=int(grey[0, 0]))
    trns_rgb = png(rgb, transparency=tuple(int(v) for v in rgb[0, 0]))
    return {
        "largest-first": ico_file([(12, 9, 0, 32, png(small)),
                                   (24, 18, 0, 32, png(rgb)),
                                   (12, 9, 0, 8, png(small, "L"))]),
        "two-of-one-size-fewer-bits-first": ico_file([
            (24, 18, 0, 32, png(rgb)), (24, 18, 0, 8, png(grey))]),
        "two-of-one-size-file-order": ico_file([
            (24, 18, 0, 32, png(rgb)), (24, 18, 0, 32, png(grey))]),
        "colour-count-depth": ico_file([
            (24, 18, 0, 0, png(rgb)), (24, 18, 16, 0, png(grey))]),
        "one-colour": ico_file([
            (24, 18, 1, 0, png(grey)), (24, 18, 0, 0, png(rgb))]),
        "equal-area-other-shape": ico_file([
            (18, 24, 0, 32, png(grey)), (24, 18, 0, 32, png(rgb))]),
        "size-not-the-directory's": ico_file([(40, 40, 0, 32, png(small))]),
        "256-as-zero": ico_file([(256, 256, 0, 32, png(small))]),
        "palette-trns-unapplied": ico_file([(24, 18, 0, 32, trns_p)]),
        "grey-trns-unapplied": ico_file([(24, 18, 0, 32, trns_l)]),
        "rgb-trns-unapplied": ico_file([(24, 18, 0, 32, trns_rgb)]),
        "grey-alpha": ico_file([(24, 18, 0, 32, pil_file(
            Image.fromarray(grey).convert("LA"), "PNG"))]),
        "one-bit": ico_file([(24, 18, 0, 1, png(grey > 100))]),
        "16-bit-rgb": ico_file([(3, 2, 0, 48, ti.png_bytes(
            np.arange(18).reshape(2, 3, 3) * 3001, 2, 16))]),
        "interlaced": ico_file([(9, 7, 0, 32, ti.png_bytes(
            small[:7, :9], 2, 8, interlace=1))]),
        "frame-past-the-end": ico_file([(24, 18, 0, 32, png(rgb))])[:22],
        "offset-past-the-end": ico_file([(24, 18, 0, 32, png(rgb))]).replace(
            struct.pack("<I", 22), struct.pack("<I", 99999), 1),
        "dib-header-pil-refuses": ico_file([(24, 18, 0, 32, struct.pack(
            "<I", 1000) + bytes(40))]),
        "png-cut-short": ico_file([(24, 18, 0, 32, png(rgb)[:-40])]),
        "png-bad-crc": ico_file([(24, 18, 0, 32, png(rgb)[:30] + b"\0\0"
                                  + png(rgb)[32:])]),
        "zero-frames": b"\0\0\1\0\0\0" + bytes(32),
        "cut-directory": ico_file([(24, 18, 0, 32, png(rgb)),
                                   (12, 9, 0, 32, png(small))])[:30],
    }


ICO_CASES = _ico_cases()


@pytest.mark.parametrize("case", sorted(ICO_CASES))
def test_hand_made_ico_reads_as_jax(case, tmp_path):
    as_jax(tmp_path, "x.ico", ICO_CASES[case])


def test_hand_made_ico_cases_are_read_by_pil_where_named(tmp_path):
    """The cases that name a frame PIL reads are not None in PIL (the
    others are its failures)."""
    failing = {"frame-past-the-end", "offset-past-the-end",
               "dib-header-pil-refuses", "png-cut-short", "png-bad-crc",
               "zero-frames", "cut-directory"}
    for case, data in ICO_CASES.items():
        path = tmp_path / f"{case}.ico"
        path.write_bytes(data)
        assert (jimage.load_rgba(str(path)) is None) == (case in failing), \
            case


def block(kind: bytes, body: bytes) -> bytes:
    return kind + struct.pack(">I", 8 + len(body)) + body


def icns_file(*blocks, toc: bool = True) -> bytes:
    body = b"".join(blocks)
    if toc:
        body = block(b"TOC ", b"".join(b[:8] for b in blocks)) + body
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def _icns_cases():
    big = pixels(64, 64, "RGB", 11)
    s1024 = png(resample.resize(big, (1024, 1024)))
    s512 = png(resample.resize(big, (512, 512), resample.LANCZOS), "L")
    s256 = png(resample.resize(big, (256, 256)))
    s32 = png(big[:32, :32])
    p512 = pil_file(Image.fromarray(resample.resize(big, (512, 512))).quantize(
        9), "PNG", transparency=3)
    return {
        "ic10": icns_file(block(b"ic10", s1024)),
        "ic09-grey": icns_file(block(b"ic09", s512)),
        "ic14-is-1024": icns_file(block(b"ic14", s1024),
                                  block(b"ic09", s512)),
        "largest-wins-whatever-order": icns_file(
            block(b"ic11", s32), block(b"ic08", s256),
            block(b"ic07", png(resample.resize(big, (128, 128))))),
        "no-toc": icns_file(block(b"icp5", s32), toc=False),
        "repeated-type-last-kept": icns_file(block(b"ic08", s256),
                                             block(b"ic08", png(
                                                 resample.resize(
                                                     big[::-1], (256, 256))))),
        "size-not-the-entry's": icns_file(block(b"ic08", png(big[:16]))),
        "integral-fraction-allowed": icns_file(block(b"ic08", s32)),
        "half-size-allowed": icns_file(block(b"ic14", s512)),
        "palette-trns-unapplied": icns_file(block(b"ic09", p512)),
        "rle-size-below-png": icns_file(block(b"ih32", bytes(10)),
                                        block(b"ic08", s256)),
        "zero-block": icns_file(block(b"ic10", s1024))[:12] + bytes(4)
        + icns_file(block(b"ic10", s1024))[16:],
        "cut-inside-the-last-block": icns_file(block(b"ic08", s256))[:-10],
        "file-length-past-the-end": b"icns" + struct.pack(">I", 33 + len(
            s256)) + icns_file(block(b"ic08", s256))[8:],
        "header-only": b"icns" + struct.pack(">I", 8),
        "cut-header": b"icns\0\0",
        "not-png-or-jpeg2000": icns_file(block(b"ic08", b"GIF89a" + s256)),
        "png-cut-short": icns_file(block(b"ic08", s256[:-50])),
        "no-known-entry": icns_file(block(b"abcd", s256)),
    }


ICNS_CASES = _icns_cases()


@pytest.mark.parametrize("case", sorted(ICNS_CASES))
def test_hand_made_icns_reads_as_jax(case, tmp_path):
    as_jax(tmp_path, "x.icns", ICNS_CASES[case])


def test_hand_made_icns_cases_are_read_by_pil_where_named(tmp_path):
    failing = {"size-not-the-entry's", "zero-block",
               "file-length-past-the-end",
               "header-only", "cut-header", "not-png-or-jpeg2000",
               "png-cut-short", "no-known-entry"}
    for case, data in ICNS_CASES.items():
        path = tmp_path / f"{case}.icns"
        path.write_bytes(data)
        assert (jimage.load_rgba(str(path)) is None) == (case in failing), \
            case


@pytest.mark.parametrize("kind,body", [
    (b"ic07", b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a" + bytes(20)),
    (b"ic08", b"\xff\x4f\xff\x51" + bytes(20)),
], ids=["jp2", "j2k"])
def test_icns_rle_mask_and_jpeg2000_entries_are_refused(kind, body,
                                                        tmp_path):
    """JPEG 2000 entries of junk after their signatures: None, as in the
    JAX package (PIL's JPEG 2000 reader fails on them). The RLE and mask
    entries once refused here decode (``tests/test_torch_bmp_icons.py``);
    a JPEG 2000 flavour the port does not decode raises naming the file
    (``tests/test_torch_formats.py``)."""
    data = icns_file(block(kind, body),
                     block(b"ic11", png(pixels(32, 32, "RGB", 1))))
    as_jax(tmp_path, f"old_{kind.decode()}.icns", data)
    assert image.load_rgba(str(tmp_path / f"old_{kind.decode()}.icns")) \
        is None


def test_the_committed_fixtures_are_pils_files(tmp_path):
    """``small.ico`` and ``small_6x5_grey.icns`` read as in the JAX
    package (their digests are ``tests/test_torch_formats.py``'s)."""
    for name in ("small.ico", "small_6x5_grey.icns"):
        with open(os.path.join(REPO, "tests", "torch_data", name), "rb") as f:
            rgba = held(tmp_path, name, f.read())
        assert rgba.shape == ((19, 24, 4) if name.endswith(".ico")
                              else (1024, 1024, 4))


# ---- scenes ----------------------------------------------------------------

def icon_maps(tmp_path):
    """Paths of an ICNS roughness map (the port's writer, read at its
    1024x1024 ``ic10`` entry) and an ICO normal map (read at its 48x36
    frame), both of procedural content."""
    rough = tmp_path / "rough.icns"
    image.write_image(str(rough), fx.procedural_rgb(40, 24, 5))
    normal = tmp_path / "normal.ico"
    image.write_image(str(normal), fx.procedural_rgb(64, 48, 7))
    return str(rough), str(normal)


def test_map_files_are_what_pil_reads(tmp_path):
    for path in icon_maps(tmp_path):
        with open(path, "rb") as f:
            held(tmp_path, "x" + os.path.splitext(path)[1], f.read())


def test_compile_with_icns_and_ico_maps_equals_jax(tmp_path):
    rough, normal = icon_maps(tmp_path)
    jsc = cornell_scene(depth=2, res=(16, 16),
                        block_types=(MaterialType.GLOSSY, MaterialType.GLOSSY))
    jsc.set_roughness_texture(0, 6, rough)
    jsc.set_roughness_texture(0, 7, rough)
    jsc.set_normal_texture(0, 3, normal)
    got = to_port_scene(jsc).compile("cpu", build_bvh=False)
    assert got.textures.shape == (2, 1024, 1024, 4)
    assert_fields_equal(jsc.compile(build_bvh=False), got)


def test_icns_and_ico_mapped_trace_matches_jax_under_one_key(tmp_path):
    """The glossy wall of ``normal_mapped_wall`` with the ICNS roughness
    map and the ICO normal map (rtol 1e-4 / atol 1e-6)."""
    rough, normal = icon_maps(tmp_path)
    jsc = normal_mapped_wall(tmp_path)
    jsc.set_roughness_texture(0, 0, rough)
    jsc.set_normal_texture(0, 0, normal)
    got, want = trace_both(jsc, jsc.trace_depth, 5, False)
    assert_same(got, want)
    assert np.asarray(want.radiance).max() > 0


_NO_JAX_ICONS = r"""
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
rough = os.path.join(tmp, "r.icns")
image.write_image(rough, fx.procedural_rgb(40, 24, 3))
normal = os.path.join(tmp, "n.ico")
image.write_image(normal, fx.procedural_rgb(40, 32, 4))
with fx.pinned_gmtime():
    image.write_image(os.path.join(tmp, "w.pdf"), fx.procedural_rgb(9, 7, 1))
assert image.load_rgba8(os.path.join(data_dir, "small.ico")).shape == (
    19, 24, 4)
assert image.load_rgba8(os.path.join(data_dir, "small_6x5_grey.icns")).shape \
    == (1024, 1024, 4)
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
assert tuple(data.textures.shape) == (2, 1024, 1024, 4), data.textures.shape
img = pt.RenderSession(sc, "cpu", seed=1).run(2, batch=2)
assert img.shape == (8, 12, 4) and np.isfinite(img).all() and img.mean() > 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "PIL"))
assert not bad, bad
print("ok")
"""


def test_icon_mapped_render_imports_neither_jax_nor_pil(tmp_path):
    res = subprocess.run(
        [sys.executable, "-I", "-c", _NO_JAX_ICONS, REPO, str(tmp_path)],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().endswith("ok")
