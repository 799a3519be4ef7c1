#!/usr/bin/env python3
"""Hold the port's TIFF reader (``utils/image.py``) to PIL 12.1 on the
TIFFs scientific and GIS tools write: BigTIFF, the floating-point
predictor, 12-bit grey and uncompressed separate 16-bit planes, valid
and damaged.

Each case is written to a file and read by its path as the JAX package
reads a texture, ``PIL.Image.open(path).convert("RGBA")`` with any
exception None, and by the port's ``image.load_rgba8``; where PIL opens
the file as mode ``I;16`` or ``I;16B`` the port is held to the named
deviation instead (PIL's samples shifted down to their top 8 bits: a
12-bit sample by 4, a 16-bit one by 8).

The files, drawn at random (widths 1 to 40, heights 1 to 12):

- BigTIFF: PIL's classic file of a random mode (1, L, LA, P, RGB, RGBA,
  CMYK, YCbCr, I, F, I;16) under a random compression it writes
  (none, LZW, Deflate, PackBits, LZMA, ZSTD, JPEG, the CCITT ones for 1)
  turned into a BigTIFF (``torch_images.bigtiff_of``: LONG8 or LONG
  offsets, values of up to 8 bytes inline), PIL's own ``big_tiff=True``
  file, or a hand-made one in either byte order (a big-endian BigTIFF
  PIL takes for a classic file);
- predictor 3: float32 samples (NaN, infinities and huge values among
  them) under LZW, Deflate, Adobe Deflate, LZMA or ZSTD, strips or
  tiles, either byte order, classic or BigTIFF, by hand or PIL's own
  file; and the predictor on integer samples, predictor 2 at 1, 2, 4
  and 12 bits and predictor values other than 1-3 (None in both);
- 12-bit samples: grey or 2 and 3 samples, min-is-black or white, fill
  order 1 or 2, either byte order, uncompressed or under LZW, Deflate,
  PackBits, LZMA or ZSTD, with or without predictor 2, strips or tiles,
  an orientation;
- separate 16-bit planes: RGB, RGBA (extra samples none, 0, 1 or 2) and
  CMYK, uncompressed in one strip or several per plane or in tiles,
  either byte order, classic or BigTIFF, an orientation.

Every file is also cut at every byte (``--cuts 0``) or at ``--cuts``
places, and damaged by ``--flips`` single-bit flips, those inside the
IFD and the values it points to counted apart (``IFD flip``: the port
copies PIL's and libtiff's checks of an entry only in part, as
``tests/test_torch_damage.py`` says), and so are compressed YCbCr files
(JPEG apart) whose damaged strip PIL reads on past through libtiff's
RGBA reader where the port gives None (``YCbCr strip failed``, the
named deviation of ``utils/image.py``). ZSTD strips come from
``zstandard`` where it is installed, else as stored blocks.

Prints the count of each kind of case (``equal``, ``both_none``,
``refused``: the port raised ``NotImplementedError``, ``differ``) and the
first differences; exits 1 on any difference outside the IFD flips. Run
from the repository root:

    python3 tools/tiff_float_big_sweep.py --seed 30 --files 60 --cuts 0 \\
        --flips 40

Needs PIL; the port imports none of it.
"""

import argparse
import collections
import io
import os
import struct
import sys
import tempfile
import warnings

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

import torch_images as ti  # noqa: E402

try:
    import zstandard

    def _zstd(raw: bytes) -> bytes:
        return zstandard.ZstdCompressor(level=3).compress(raw)
except ImportError:
    _zstd = None


def pil_rgba8(path: str):
    """The JAX package's reading, None on any exception; for PIL's modes
    ``I;16`` and ``I;16B`` the named deviation's image instead."""
    from PIL import Image
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(path) as im:
                if im.mode not in ("I;16", "I;16B"):
                    return np.asarray(im.convert("RGBA"), np.uint8)
                bits = im.tag_v2.get(258, (16,))[0]
                im.load()
                grey = (np.asarray(im).astype(np.int64) >> bits - 8).astype(
                    np.uint8)
                out = np.full(grey.shape + (4,), 255, np.uint8)
                out[..., :3] = grey[..., None]
                return out
    except Exception:  # noqa: BLE001 (the JAX package's rule)
        return None


def pil_ycbcr_codec(path: str) -> bool:
    """Whether PIL takes the file for compressed YCbCr other than JPEG,
    which it reads through libtiff's RGBA reader: that goes on past a
    strip that fails, where the port gives None (a named deviation)."""
    from PIL import Image
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(path) as im:
                return (im.tag_v2.get(262) == 6
                        and im.tag_v2.get(259, 1) not in (1, 6, 7))
    except Exception:  # noqa: BLE001
        return False


def pil_tiff(img_args, save: dict):
    """PIL's TIFF of ``Image.frombytes(*img_args)`` saved in a child
    process, or None where PIL fails (an exception, or libtiff's heap
    corruption ending the child)."""
    from PIL import Image
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                out = io.BytesIO()
                Image.frombytes(*img_args).save(out, "TIFF", **save)
                os.write(w, out.getvalue())
        finally:
            os._exit(0)
    os.close(w)
    chunks = []
    while True:
        chunk = os.read(r, 1 << 20)
        if not chunk:
            break
        chunks.append(chunk)
    os.close(r)
    os.waitpid(pid, 0)
    return b"".join(chunks) or None


def _ifd_ranges(data: bytes):
    """[start, end) of the first IFD (classic or BigTIFF, as PIL takes it
    by the third byte) and of the values its entries point to."""
    try:
        order = "<" if data[:2] == b"II" else ">"
        big = data[2] == 43
        head, entry, fmt = (8, 20, "HHQ8s") if big else (2, 12, "HHI4s")
        (at,) = struct.unpack_from(order + ("Q" if big else "I"), data,
                                   8 if big else 4)
        (n,) = struct.unpack_from(order + ("Q" if big else "H"), data, at)
        out = [(0, 16), (at, at + head + entry * n + head)]
        for i in range(n):
            _, kind, count, value = struct.unpack_from(
                order + fmt, data, at + head + entry * i)
            size = ti._TIFF_UNIT.get(kind, 1) * count
            if size > len(value):
                (off,) = struct.unpack(order + ("Q" if big else "I"), value)
                out.append((off, off + size))
        return out
    except struct.error:
        return [(0, len(data))]


# ---- random files -----------------------------------------------------------

MODES = ("1", "L", "LA", "P", "RGB", "RGBA", "CMYK", "YCbCr", "I", "F",
         "I;16")
PIL_COMPRESSIONS = ("raw", "tiff_lzw", "tiff_adobe_deflate", "packbits",
                    "tiff_deflate", "lzma", "zstd", "jpeg", "group3",
                    "group4", "tiff_ccitt")
PREDICTED = (5, 8, 32946, 34925, 50000)
COMPRESSIONS = (1, 5, 8, 32946, 32773, 34925, 50000)


def _size(r):
    return int(r.integers(1, 41)), int(r.integers(1, 13))


def _layout(r, w: int, h: int) -> dict:
    pick = int(r.integers(0, 3))
    if pick == 0:
        return {}
    if pick == 1:
        return {"rows_per_strip": int(r.integers(1, h + 1))}
    return {"tile": (16 * int(r.integers(1, 3)), 16 * int(r.integers(1, 3)))}


def _pil_args(r, mode: str, w: int, h: int):
    bands = {"1": 1, "L": 1, "LA": 2, "P": 1, "RGB": 3, "RGBA": 4,
             "CMYK": 4, "YCbCr": 3}
    if mode == "F":
        return "F", (w, h), _floats(r, w, h, 1).tobytes()
    if mode == "I":
        return "I", (w, h), r.integers(-300, 600, (h, w)).astype(
            "<i4").tobytes()
    if mode == "I;16":
        return "I;16", (w, h), r.integers(0, 65536, (h, w)).astype(
            "<u2").tobytes()
    if mode == "1":
        return "L", (w, h), (r.integers(0, 2, (h, w)) * 255).astype(
            np.uint8).tobytes()
    return mode, (w, h), r.integers(0, 256, (h, w, bands[mode]),
                                    np.uint8).tobytes()


def _floats(r, w: int, h: int, spp: int) -> np.ndarray:
    f = (r.random((h, w, spp)) * 400 - 60).astype(np.float32)
    for v in (np.nan, np.inf, -np.inf, 3e38, -1e-30, 255.9, 0.5):
        if r.random() < 0.2:
            f[int(r.integers(0, h)), int(r.integers(0, w)), 0] = v
    return f


def big_file(r) -> bytes:
    w, h = _size(r)
    pick = r.random()
    if pick < 0.6:                        # PIL's classic file, made BigTIFF
        for _ in range(20):
            mode = str(r.choice(MODES))
            comp = str(r.choice(PIL_COMPRESSIONS))
            if comp in ("group3", "group4", "tiff_ccitt") and mode != "1" \
                    or comp == "jpeg" and mode not in ("L", "RGB", "CMYK",
                                                       "YCbCr", "LA"):
                continue
            args = _pil_args(r, mode, w, h)
            if mode == "1":
                args = ("1",) + args[1:2] + (np.packbits(np.frombuffer(
                    args[2], np.uint8).reshape(h, w) > 0, axis=1).tobytes(),)
            data = pil_tiff(args, {"compression": comp})
            if data is not None:
                return ti.bigtiff_of(data, int(r.choice([4, 16])))
    if pick < 0.8:                        # PIL's own BigTIFF
        mode = str(r.choice(("L", "RGB", "RGBA", "F", "I", "I;16", "CMYK")))
        data = pil_tiff(_pil_args(r, mode, w, h), {"big_tiff": True})
        if data is not None:
            return data
    spp = int(r.choice([1, 3]))
    return ti.tiff_bytes(r.integers(0, 256, (h, w, spp)), 8,
                         compression=int(r.choice(COMPRESSIONS)),
                         order=str(r.choice(["<", ">"])), big=True,
                         offset_type=int(r.choice([4, 16])), zstd=_zstd,
                         **_layout(r, w, h))


def pred3_file(r) -> bytes:
    w, h = _size(r)
    pick = r.random()
    if pick < 0.15:                       # PIL's own, little-endian
        data = pil_tiff(("F", (w, h), _floats(r, w, h, 1).tobytes()), {
            "compression": str(r.choice(["tiff_lzw", "tiff_adobe_deflate",
                                         "lzma", "zstd"])),
            "tiffinfo": {317: 3}})
        if data is not None:
            return data
    if pick < 0.8:
        return ti.tiff_bytes(_floats(r, w, h, 1), 32, sample_format=3,
                             compression=int(r.choice(PREDICTED)),
                             predictor=3, order=str(r.choice(["<", ">"])),
                             big=bool(r.random() < 0.3), zstd=_zstd,
                             **_layout(r, w, h))
    # the predictors libtiff refuses: None in both
    bits = int(r.choice([1, 2, 4, 8, 12, 16, 32]))
    predictor = int(r.choice([0, 2, 3, 4, 9])) if bits >= 8 else 2
    spp = int(r.choice([1, 3])) if bits == 8 else 1
    return ti.tiff_bytes(r.integers(0, min(1 << bits, 256), (h, w, spp)),
                         bits, compression=int(r.choice(PREDICTED)),
                         predictor=predictor, zstd=_zstd,
                         sample_format=int(r.choice([1, 2])) if bits >= 16
                         else None, **_layout(r, w, h))


def grey12_file(r) -> bytes:
    w, h = _size(r)
    spp = 1 if r.random() < 0.8 else int(r.choice([2, 3]))
    photo = (int(r.choice([1, 1, 1, 0])) if spp < 3 else 2)
    tags = []
    if r.random() < 0.2:
        tags.append((274, 3, [int(r.integers(1, 9))]))
    return ti.tiff_bytes(
        r.integers(0, 4096, (h, w, spp)), 12, photometric=photo,
        compression=int(r.choice(COMPRESSIONS)),
        predictor=2 if r.random() < 0.15 else 1,
        order=str(r.choice(["<", "<", ">"])),
        fill_order=2 if r.random() < 0.1 else None,
        big=bool(r.random() < 0.2), zstd=_zstd, extra_tags=tags,
        **_layout(r, w, h))


def planar16_file(r) -> bytes:
    w, h = _size(r)
    photo, spp, extra = [(2, 3, None), (2, 4, None), (2, 4, [0]),
                         (2, 4, [1]), (2, 4, [2]), (5, 4, None)][
        int(r.integers(0, 6))]
    tags = []
    if r.random() < 0.2:
        tags.append((274, 3, [int(r.integers(1, 9))]))
    return ti.tiff_bytes(
        r.integers(0, 65536, (h, w, spp)), 16, photometric=photo, planar=2,
        extra=extra, order=str(r.choice(["<", ">"])),
        big=bool(r.random() < 0.3), extra_tags=tags, **_layout(r, w, h))


KINDS = {"BigTIFF": big_file, "predictor 3": pred3_file,
         "12-bit": grey12_file, "planar 16": planar16_file}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=30)
    ap.add_argument("--files", type=int, default=60,
                    help="random files of each kind")
    ap.add_argument("--cuts", type=int, default=0,
                    help="cuts of each file (0: every byte)")
    ap.add_argument("--flips", type=int, default=40)
    args = ap.parse_args()
    from pathtracing_spectrum_tpu_torch.utils import image
    r = np.random.default_rng(args.seed)
    counts, differ = collections.Counter(), []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "case.tif")

        def held(kind: str, data: bytes, what) -> None:
            with open(path, "wb") as f:
                f.write(data)
            want = pil_rgba8(path)
            try:
                got = image.load_rgba8(path)
            except NotImplementedError as e:
                counts[f"{kind} refused ({str(e).split('(')[1][:30]})"] += 1
                return
            if want is None or got is None:
                verdict = "both_none" if want is None and got is None \
                    else "differ"
                if got is None and want is not None and pil_ycbcr_codec(
                        path):
                    verdict = "YCbCr strip failed (named deviation)"
            else:
                verdict = ("equal" if want.shape == got.shape
                           and np.array_equal(want, got) else "differ")
            counts[f"{kind} {verdict}"] += 1
            if verdict == "differ" and not kind.endswith("IFD flip") \
                    and len(differ) < 20:
                differ.append((kind, what, want is None, got is None,
                               data[:64]))

        for kind, make in KINDS.items():
            for i in range(args.files):
                data = make(r)
                held(kind, data, (i, "whole"))
                cuts = (range(len(data)) if args.cuts == 0 else
                        r.integers(0, len(data) + 1, args.cuts))
                for cut in cuts:
                    held(kind + " cut", data[:int(cut)], (i, int(cut)))
                ranges = _ifd_ranges(data)
                for _ in range(args.flips):
                    damaged = bytearray(data)
                    at = int(r.integers(0, len(data)))
                    damaged[at] ^= 1 << int(r.integers(0, 8))
                    where = ("IFD flip" if any(lo <= at < hi
                                               for lo, hi in ranges)
                             else "flip")
                    held(f"{kind} {where}", bytes(damaged), (i, at))
    for key in sorted(counts):
        print(f"{key}: {counts[key]}")
    for d in differ:
        print("DIFFER", d)
    n = sum(v for k, v in counts.items()
            if k.endswith("differ") and "IFD flip" not in k)
    print(f"{sum(counts.values())} cases, {n} differ (IFD flips apart: "
          f"{sum(v for k, v in counts.items() if 'IFD flip differ' in k)})")
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
