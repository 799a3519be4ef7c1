#!/usr/bin/env python3
"""Hold the port's CIELab reading (``utils/cielab.py`` over the host
library's ``csrc/lab_srgb.cpp``, and the TIFF and PSD readers of
``utils/image.py``) to PIL 12.1 and its LittleCMS 2.17.

Three parts:

- ``triples``: the numpy plain version (``cielab.lab_rgb_plain``) and the
  host library's interpolation (``cielab.lab_rgba``) on all 2**24 Lab
  triples against PIL's ``convert("RGBA")`` (``torch_images.pil_lab_rgba8``);
- ``table``: the port's table at its 35,937 nodes against LittleCMS's own
  unoptimised 16-bit transform at the same nodes, through ctypes
  (``torch_images.lcms_table``);
- ``files``: random files, each written to a file and read by its path as
  the JAX package reads a texture, ``PIL.Image.open(path).convert("RGBA")``
  with any exception None, and by the port's ``image.load_rgba8``:

  - PIL's CIELab TIFFs (widths 1 to 40, heights 1 to 12) under every
    compression it writes (none, LZW, Deflate, Adobe Deflate, PackBits,
    JPEG, LZMA, ZSTD), with predictor 2 where libtiff runs it, classic or
    BigTIFF, an orientation;
  - hand-made ones (``torch_images.tiff_bytes``, ``jpeg_tiff_bytes``):
    none, LZW, Deflate, Adobe Deflate, PackBits, LZMA, ZSTD (with and
    without predictor 2) and JPEG (4:4:4, or 4:2:0, which libtiff
    refuses), either byte order, strips or tiles, contiguous or separate
    planes, classic or BigTIFF, an orientation; and the keys PIL has no
    mode for (16-bit Lab, Lab and an extra sample, ICCLab, ITULab, fill
    order 2);
  - PSDs of colour mode 9: raw or RLE, 2, 3 or 4 channels, 8 or (rarely)
    16 bits.

  Every file is also cut at every byte (``--cuts 0``) or at ``--cuts``
  places, and damaged by ``--flips`` single-bit flips; the flips of a
  TIFF inside its IFD and the values it points to are counted apart
  (``IFD flip``: the port copies PIL's and libtiff's checks of an entry
  only in part, as ``tests/test_torch_damage.py`` says).

Prints the count of each kind of case (``equal``, ``both_none``,
``refused``: the port raised ``NotImplementedError``, ``differ``) and the
first differences; exits 1 on any difference outside the IFD flips. Run
from the repository root:

    python3 tools/cielab_sweep.py --seed 31

Needs PIL; the port imports none of it.
"""

import argparse
import collections
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))
sys.path.insert(0, os.path.join(HERE, "tools"))

import torch_images as ti  # noqa: E402
from tiff_float_big_sweep import (_ifd_ranges, _layout, _size, _zstd,  # noqa: E402,E501
                                  pil_rgba8, pil_tiff)

PIL_COMPRESSIONS = ("raw", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate",
                    "packbits", "jpeg", "lzma", "zstd")
COMPRESSIONS = (1, 5, 8, 32946, 32773, 34925, 50000)
PREDICTED = (5, 8, 32946, 34925, 50000)


def _orientation(r) -> list:
    return [(274, 3, [int(r.integers(1, 9))])] if r.random() < 0.25 else []


def pil_file(r) -> bytes:
    w, h = _size(r)
    comp = str(r.choice(PIL_COMPRESSIONS))
    save = {"compression": comp, "big_tiff": bool(r.random() < 0.3)}
    tags = {}
    if comp in ("tiff_lzw", "tiff_deflate", "tiff_adobe_deflate", "lzma",
                "zstd") and r.random() < 0.4:
        tags[317] = 2
    if r.random() < 0.25:
        tags[274] = int(r.integers(1, 9))
    if tags:
        save["tiffinfo"] = tags
    data = pil_tiff(("LAB", (w, h), r.integers(0, 256, (h, w, 3),
                                                np.uint8).tobytes()), save)
    return data if data is not None else hand_file(r)


def hand_file(r) -> bytes:
    w, h = _size(r)
    px = r.integers(0, 256, (h, w, 3), np.uint8)
    if r.random() < 0.5:                       # runs for the codecs
        px[:, :w // 2] = px[:, :1]
    order = str(r.choice(["<", ">"]))
    big = bool(r.random() < 0.3)
    if r.random() < 0.15:                      # JPEG: 4:4:4, or refused 4:2:0
        layout = ({"tile": (16, 16)} if r.random() < 0.4 else
                  {"rows_per_strip": int(r.integers(1, h + 1))})
        data = ti.jpeg_tiff_bytes(px, subsampling=int(r.choice([0, 0, 0, 2])),
                                  photometric=8, order=order,
                                  tables=bool(r.random() < 0.5), **layout)
        return ti.bigtiff_of(data) if big and order == "<" else data
    if r.random() < 0.1:                       # keys PIL has no mode for
        photo, samples, extra, bits, fill = [
            (8, 3, None, 16, None), (8, 4, [2], 8, None),
            (8, 4, [0], 8, None), (9, 3, None, 8, None),
            (10, 3, None, 8, None), (8, 3, None, 8, 2)][int(r.integers(0, 6))]
        return ti.tiff_bytes(
            r.integers(0, 1 << min(bits, 16), (h, w, samples)), bits,
            photometric=photo, extra=extra, fill_order=fill,
            compression=int(r.choice(COMPRESSIONS)), order=order, big=big,
            zstd=_zstd, **_layout(r, w, h))
    comp = int(r.choice(COMPRESSIONS))
    return ti.tiff_bytes(
        px, photometric=8, compression=comp,
        predictor=2 if comp in PREDICTED and r.random() < 0.4 else 1,
        order=order, planar=2 if r.random() < 0.2 else 1, big=big,
        zstd=_zstd, extra_tags=_orientation(r), **_layout(r, w, h))


def psd_file(r) -> bytes:
    w, h = _size(r)
    n = int(r.choice([2, 3, 3, 3, 4]))
    depth = 16 if r.random() < 0.05 else 8
    ch = r.integers(0, 256, (n, h, w))
    if r.random() < 0.5:
        ch[:, :, :w // 2] = ch[:, :, :1]
    return ti.psd_bytes(ch * (257 if depth == 16 else 1), 9, depth=depth,
                        rle=bool(r.random() < 0.5))


KINDS = {"TIFF PIL": (pil_file, ".tif"), "TIFF hand": (hand_file, ".tif"),
         "PSD": (psd_file, ".psd")}


def triples() -> int:
    """The differences of the plain and host versions from PIL over all
    2**24 triples, 2**20 at a time."""
    from pathtracing_spectrum_tpu_torch.utils import cielab
    differ = 0
    t0 = time.perf_counter()
    for start in range(0, 1 << 24, 1 << 20):
        v = np.arange(start, start + (1 << 20), dtype=np.uint32)
        lab = np.stack([v >> 16, (v >> 8) & 255, v & 255], -1).astype(
            np.uint8)
        want = ti.pil_lab_rgba8(lab)
        plain = (cielab.lab_rgb_plain(lab) != want[:, :3]).any(-1)
        host = (cielab.lab_rgba(lab, 255) != want).any(-1)
        differ += int((plain | host).sum())
    print(f"triples: 16777216 through the plain and host versions, "
          f"{differ} differ ({time.perf_counter() - t0:.1f} s)")
    return differ


def table() -> int:
    from pathtracing_spectrum_tpu_torch.utils import cielab
    nodes = int((cielab.table() != ti.lcms_table()).any(-1).sum())
    print(f"table: 35937 nodes against LittleCMS, {nodes} differ")
    return nodes


def files(args) -> int:
    from pathtracing_spectrum_tpu_torch.utils import image
    r = np.random.default_rng(args.seed)
    counts, differ = collections.Counter(), []
    with tempfile.TemporaryDirectory() as tmp:

        def held(kind: str, ext: str, data: bytes, what) -> None:
            path = os.path.join(tmp, "case" + ext)
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
            else:
                verdict = ("equal" if want.shape == got.shape
                           and np.array_equal(want, got) else "differ")
            counts[f"{kind} {verdict}"] += 1
            if verdict == "differ" and not kind.endswith("IFD flip") \
                    and len(differ) < 20:
                differ.append((kind, what, want is None, got is None,
                               data[:64]))

        for kind, (make, ext) in KINDS.items():
            for i in range(args.files):
                data = make(r)
                held(kind, ext, data, (i, "whole"))
                cuts = (range(len(data)) if args.cuts == 0 else
                        r.integers(0, len(data) + 1, args.cuts))
                for cut in cuts:
                    held(kind + " cut", ext, data[:int(cut)], (i, int(cut)))
                ranges = _ifd_ranges(data) if ext == ".tif" else []
                for _ in range(args.flips):
                    damaged = bytearray(data)
                    at = int(r.integers(0, len(data)))
                    damaged[at] ^= 1 << int(r.integers(0, 8))
                    where = ("IFD flip" if any(lo <= at < hi
                                               for lo, hi in ranges)
                             else "flip")
                    held(f"{kind} {where}", ext, bytes(damaged), (i, at))
    for key in sorted(counts):
        print(f"{key}: {counts[key]}")
    for d in differ:
        print("DIFFER", d)
    n = sum(v for k, v in counts.items()
            if k.endswith("differ") and "IFD flip" not in k)
    print(f"files: {sum(counts.values())} cases, {n} differ (IFD flips "
          f"apart: {sum(v for k, v in counts.items() if 'IFD flip differ' in k)})")
    return n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=31)
    ap.add_argument("--files", type=int, default=60,
                    help="random files of each kind")
    ap.add_argument("--cuts", type=int, default=0,
                    help="cuts of each file (0: every byte)")
    ap.add_argument("--flips", type=int, default=40)
    ap.add_argument("--parts", default="triples,table,files",
                    help="comma-separated: triples, table, files")
    args = ap.parse_args()
    parts = args.parts.split(",")
    n = 0
    if "table" in parts:
        n += table()
    if "triples" in parts:
        n += triples()
    if "files" in parts:
        n += files(args)
    print(f"total: {n} differ")
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
