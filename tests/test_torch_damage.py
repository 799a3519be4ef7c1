"""Damaged image files: the port's loader against the JAX package's (PIL
12.1), on every committed fixture (QOI, DXT5 and uncompressed DDS, ICO
and ICNS among them; FITS, GZIP_1 FITS, McIDAS, SPIDER, PIXAR, IMT, XV
thumbnail and DCX files, and Sun rasters (raw, palette, run-length),
GIMP brushes, MSP (``DanM``, ``LinS``), XBM and XPM files, and FLI and
FLC animations and IPTC records (raw, a band, a JPEG inside), and
BigTIFFs, predictor-3 float, 12-bit grey and separate 16-bit plane
TIFFs, and a CIELab LZW TIFF and RLE PSD, each of them small enough for
a case at nearly every byte) and
``assets/checker.png`` cut short and with single
bits flipped. Both must give None (PIL raises), or the same
image bit for bit. One test per fixture and kind of damage, looping over
its cases; a small file gets a case for nearly every byte, a large one a
few dozen, most in its headers (for an ICNS file also its table of
contents, each block's header and the head of the ``ic10`` PNG it loads).

Deviations named here and in ``utils/image.py``'s docstring:

- a flavour the port refuses raises ``NotImplementedError`` first, so it
  raises where PIL would go on to fail on the damaged file too (a
  lossless JPEG frame made by a damaged marker, a progressive JPEG whose
  damage leaves coefficients incomplete);
- 16-bit grey PNG, TIFF, P5 and FITS keep the high byte and 12-bit grey
  TIFF its top 8 bits (the fixtures ``grey16.*`` and ``grey12.tif``):
  there both must decode or both fail, with no pixel compared;
- a TIFF damaged inside its directory (the entries and the values they
  point to): PIL's and libtiff's checks of each entry are copied only in
  part (``_tiff_ifd``), so these flips are not held; cuts, and flips of
  the header and of the strips and tiles, are (LZMA and ZSTD strips too:
  liblzma's errors past the strip's last byte unseen as libtiff leaves
  them; libzstd's stops and checks as ``csrc/zstd_decode.cpp`` lists
  them);
- a compressed YCbCr TIFF whose strip fails (libtiff's RGBA reader goes
  on past it for PIL), a ZSTD match past the window into libzstd's
  wrapped ring buffer and McIDAS lines that overlap past the memory map
  PIL reads them through (refused): no fixture has any of them.

Cases whose damaged header gives a picture of more than 16 megapixels are
skipped: both packages read the size from the same fields, and the decode
would only cost memory.
"""

import io
import json
import os
import struct
import warnings

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from PIL import Image  # noqa: E402

from pathtracing_spectrum_tpu.utils import image as jimage  # noqa: E402
from pathtracing_spectrum_tpu_torch.utils import image  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "torch_data")
with open(os.path.join(DATA, "digests.json")) as _f:
    FIXTURES = sorted(json.load(_f))
FILES = [os.path.join(DATA, n) for n in FIXTURES] + [
    os.path.join(os.path.dirname(HERE), "assets", "checker.png")]
SMALL = 8192          # bytes: a case for nearly every byte below this
MAX_PIXELS = 16 << 20


def _tiff_directory(data: bytes):
    """The [start, end) ranges of a TIFF's or BigTIFF's first IFD and of
    the values its entries point to (the strips or tiles may lie before
    or after it: libtiff writes them first)."""
    order = "<" if data[:2] == b"II" else ">"
    big = data[2] == 43
    head, entry, fmt = (8, 20, "HHQ8s") if big else (2, 12, "HHI4s")
    at = struct.unpack_from(order + ("Q" if big else "I"), data,
                            8 if big else 4)[0]
    n = struct.unpack_from(order + ("Q" if big else "H"), data, at)[0]
    ranges = [(at, at + head + entry * n + head)]
    for i in range(n):
        tag, kind, count, value = struct.unpack_from(order + fmt, data,
                                                     at + head + entry * i)
        size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
                11: 4, 12: 8, 16: 8, 17: 8, 18: 8}.get(kind, 1) * count
        if size > len(value):
            off = struct.unpack(order + ("Q" if big else "I"), value)[0]
            ranges.append((off, off + size))
    return ranges


def _icns_places(data: bytes):
    """Offsets in an ICNS file's table of contents, in each block's
    header, and in the head (signature, IHDR, the first IDAT's header and
    data) of the ``ic10`` entry PIL loads."""
    out, pos = [], 8
    while pos + 8 <= len(data):
        kind, length = struct.unpack_from(">4sI", data, pos)
        out += [pos, pos + 3, pos + 4, pos + 7]
        if kind == b"TOC ":
            out += list(range(pos + 8, pos + length, 5))
        if kind == b"ic10":
            out += list(range(pos + 8, pos + 8 + 64, 3))
        pos += max(length, 8)
    return out


def cases(path: str, kind: str):
    data = open(path, "rb").read()
    n = len(data)
    step = 1 if n <= 2048 else 2
    extra = _icns_places(data) if data.startswith(b"icns") else []
    if kind == "cut":
        where = (list(range(min(n, 64))) + list(range(64, n, 3 * step))
                 if n <= SMALL else sorted(set(
                     list(range(0, 24, 2)) + list(np.linspace(24, n - 1, 8,
                                                              dtype=int))
                     + extra)))
        for k in where:
            yield k, data[:k]
        return
    where = (range(0, n, step) if n <= SMALL else sorted(set(
        list(range(0, min(n, 1024), 96)) + list(np.linspace(1024, n - 1, 4,
                                                           dtype=int))
        + extra)))
    for i in where:
        bit = (i * 5) % 8
        out = bytearray(data)
        out[i] ^= 1 << bit
        yield i, bytes(out)


def pil_size(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(io.BytesIO(data)) as im:
                return im.size[0] * im.size[1]
    except Exception:  # noqa: BLE001 (PIL's exceptions, as load_rgba)
        return 0


def held(path: str, kind: str, tmp_path):
    """Run the cases; return the number checked."""
    name = os.path.basename(path)
    ext = os.path.splitext(name)[1]
    grey16 = name.startswith(("grey16", "grey12"))
    exempt = None
    if ext == ".tif" and kind == "flip":
        exempt = _tiff_directory(open(path, "rb").read())
    target = str(tmp_path / f"damaged{ext}")
    checked = 0
    for where, data in cases(path, kind):
        if pil_size(data) > MAX_PIXELS:
            continue
        with open(target, "wb") as f:
            f.write(data)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want = jimage.load_rgba(target)
        try:
            got = image.load_rgba(target)
        except NotImplementedError:
            continue                        # a refused flavour (see above)
        checked += 1
        if exempt and any(lo <= where < hi for lo, hi in exempt):
            continue
        assert (got is None) == (want is None), (name, kind, where)
        if got is not None:
            assert got.shape == want.shape, (name, kind, where)
            if not grey16:
                np.testing.assert_array_equal(
                    got.view(np.int32), want.view(np.int32),
                    err_msg=f"{name} {kind} at {where}")
    return checked


@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_cut_files_agree_with_jax(path, tmp_path):
    assert held(path, "cut", tmp_path) > 10


@pytest.mark.parametrize("path", FILES, ids=os.path.basename)
def test_flipped_files_agree_with_jax(path, tmp_path):
    assert held(path, "flip", tmp_path) > 10
