#!/usr/bin/env python3
"""Hold the port's CCITT decoder (``utils/codecs.py::Fax``) against
libtiff's own, strip by strip, over damaged files.

PIL's TIFF writer makes mode ``1`` files under compressions 2, 3
(T4Options 0, 1, 4 and 5) and 4 at random widths (1 to 1728), heights,
strip heights, photometric interpretations and fill orders; each is then
damaged (a flipped bit, a zeroed tail, a tail of ones, random bytes, a
strip of random bytes, or a strip byte count cut short inside the file).
For every strip, PIL's bundled libtiff (``TIFFReadEncodedStrip`` through
ctypes, into a buffer filled with 0xAB) and ``codecs.Fax`` (into the same
fill, with one decoder per file, so the run array and the mode carry
from strip to strip as in libtiff) must agree: both fail, or both succeed
with every byte of the strip equal, the bytes the decoder leaves
unwritten included.

Needs PIL with its bundled libtiff (this is no test of the card).
``python3 tools/fax_libtiff_sweep.py [--seed 5] [--files 300]`` prints the
files and strips checked and the mismatches; exit 1 on any mismatch.
"""

import argparse
import ctypes
import glob
import io
import os
import struct
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from pathtracing_spectrum_tpu_torch.utils import codecs  # noqa: E402

COMPRESSIONS = {"tiff_ccitt": 2, "group3": 3, "group4": 4}


def libtiff():
    import PIL
    from PIL import Image  # noqa: F401 (loads libtiff's own libraries)
    path = glob.glob(os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                                  "pillow.libs", "libtiff-*.so*"))[0]
    lib = ctypes.CDLL(path)
    handler = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_char_p,
                               ctypes.c_void_p)
    lib._quiet = handler(lambda *a: None)
    for name in ("TIFFSetErrorHandler", "TIFFSetWarningHandler"):
        getattr(lib, name).restype = ctypes.c_void_p
        getattr(lib, name)(lib._quiet)
    lib.TIFFOpen.restype = ctypes.c_void_p
    lib.TIFFOpen.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.TIFFReadEncodedStrip.restype = ctypes.c_ssize_t
    lib.TIFFReadEncodedStrip.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                         ctypes.c_void_p, ctypes.c_ssize_t]
    lib.TIFFClose.argtypes = [ctypes.c_void_p]
    lib.TIFFNumberOfStrips.argtypes = [ctypes.c_void_p]
    lib.TIFFStripSize.argtypes = [ctypes.c_void_p]
    lib.TIFFStripSize.restype = ctypes.c_ssize_t
    return lib


def ifd(data: bytes) -> dict:
    """{tag: values} of the integer tags of a little-endian first IFD."""
    at = struct.unpack_from("<I", data, 4)[0]
    tags = {}
    for i in range(struct.unpack_from("<H", data, at)[0]):
        tag, kind, n, value = struct.unpack_from("<HHI4s", data,
                                                 at + 2 + 12 * i)
        size = {1: 1, 3: 2, 4: 4}.get(kind)
        if size is None:
            continue
        raw = value if size * n <= 4 else data[
            struct.unpack("<I", value)[0]:][:size * n]
        tags[tag] = (kind, at + 2 + 12 * i + 8 if size * n <= 4 else
                     struct.unpack("<I", value)[0],
                     struct.unpack(f"<{n}{ {1: 'B', 2: 'H', 4: 'I'}[size]}",
                                   raw[:size * n]))
    return tags


def theirs(lib, data: bytes, tmp: str):
    """[(ok, strip bytes)] of libtiff's TIFFReadEncodedStrip, or None."""
    path = os.path.join(tmp, "x.tif")
    with open(path, "wb") as f:
        f.write(data)
    t = lib.TIFFOpen(path.encode(), b"r")
    if not t:
        return None
    size = lib.TIFFStripSize(t)
    out = []
    for k in range(lib.TIFFNumberOfStrips(t)):
        buf = (ctypes.c_uint8 * size)(*([0xAB] * size))
        n = lib.TIFFReadEncodedStrip(t, k, buf, size)
        out.append((n > 0, bytes(buf)[:max(n, 0)]))
    lib.TIFFClose(t)
    return out


def mine(data: bytes):
    """[(ok, strip bytes)] of codecs.Fax on the same strips."""
    t = {k: v[2] for k, v in ifd(data).items()}
    w, h = t[256][0], t[257][0]
    scheme = t[259][0]
    options = t.get(292, (0,))[0] if scheme == 3 else 0
    rps = min(t.get(278, (h,))[0], h)
    row_bytes = (w + 7) // 8
    fax = codecs.Fax(scheme, options, w)
    rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
    out = []
    for k, (off, n) in enumerate(zip(t[273], t[279])):
        rows = min(rps, h - k * rps)
        raw = np.frombuffer(data[off:off + n], np.uint8)
        if t.get(266, (1,))[0] == 2:
            raw = rev[raw]
        buf = np.full((rows, row_bytes), 0xAB, np.uint8)
        try:
            fax.decode(raw.tobytes(), buf)
            out.append((True, buf.tobytes()))
        except codecs.BrokenData:
            out.append((False, b""))
    return out


def damaged(data: bytes, rng):
    """Damage one strip's data or its byte count."""
    tags = ifd(data)
    offs, counts = tags[273][2], tags[279][2]
    k = int(rng.integers(len(offs)))
    o, c = offs[k], counts[k]
    out = bytearray(data)
    how = int(rng.integers(6))
    i = o + int(rng.integers(c))
    if how == 0:
        out[i] ^= 1 << int(rng.integers(8))
    elif how in (1, 2):
        out[i:o + c] = bytes([0 if how == 1 else 255]) * (o + c - i)
    elif how == 3:
        for _ in range(3):
            out[o + int(rng.integers(c))] = int(rng.integers(256))
    elif how == 4:
        out[o:o + c] = rng.integers(0, 256, c, np.uint8).tobytes()
    elif c > 1:                       # the strip cut short inside the file
        kind, at, _ = tags[279]
        fmt = "<H" if kind == 3 else "<I"
        struct.pack_into(fmt, out, at + k * struct.calcsize(fmt),
                         int(rng.integers(1, c)))
    return bytes(out)


def pil_file(rng, index: int) -> bytes:
    from PIL import Image
    comp = list(COMPRESSIONS)[index % 3]
    w = int(rng.choice([1, 2, 7, 8, 9, 15, 16, 37, 80, 200, 1728]))
    h = int(rng.integers(1, 40))
    kind = int(rng.integers(3))
    if kind == 0:
        a = np.kron(rng.random(((h + 7) // 8, (w + 7) // 8)) > 0.5,
                    np.ones((8, 8), bool))[:h, :w]
    else:
        a = rng.random((h, w)) > (0.5 if kind == 1 else 0.97)
    info = {262: int(rng.integers(2)), 266: int(rng.integers(1, 3)),
            278: int(rng.integers(1, h + 1))}
    if comp == "group3":
        info[292] = int(rng.choice([0, 1, 4, 5]))
    out = io.BytesIO()
    Image.fromarray(a).save(out, "TIFF", compression=comp, tiffinfo=info)
    return out.getvalue()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--files", type=int, default=300,
                    help="clean files; each is damaged 25 ways")
    args = ap.parse_args()
    lib = libtiff()
    rng = np.random.default_rng(args.seed)
    files = strips = failed_strips = bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        for index in range(args.files):
            clean = pil_file(rng, index)
            for _ in range(25):
                data = damaged(clean, rng)
                want = theirs(lib, data, tmp)
                if want is None:
                    continue
                got = mine(data)
                files += 1
                strips += len(want)
                failed_strips += sum(not ok for ok, _ in want)
                if got != want:
                    bad += 1
                    if bad <= 10:
                        print("mismatch", index, ifd(data)[259][2])
    print(f"seed {args.seed}: {files} damaged files, {strips} strips "
          f"({failed_strips} failing in libtiff), {bad} mismatches")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
