#!/usr/bin/env python3
"""The bitmap-and-icon sweep: the port's RLE BMP and DIB, ICO, CUR and
ICNS readers against PIL 12.1 over more random files than the tier-1
tests can afford.

- RLE: BMP and DIB files of RLE8 or RLE4 packets drawn at random (runs
  that may pass the row's end, ends of line and of bitmap, deltas,
  absolute runs of any count, padded or not), 1 to 33 pixels wide, grey
  or colour palettes, a colour count in the header or not, top-down or
  not, now and then the other compression, 1, 4 or 24 bits, a cut.
- ICO and CUR: one or two DIB frames of 1, 4, 8, 24 or 32 bits, raw or
  RLE, a random AND mask, an entry's bit count that is not the DIB's,
  resource sizes too short or too long, directory sizes that are not the
  DIB's, an odd doubled height, cuts; the same bitmaps as CUR files.
- ICNS: ``is32``/``il32``/``ih32``/``it32`` entries, run-length or
  uncompressed (planar or interleaved), their masks (one cut short now
  and then), a smaller RLE entry and a JPEG 2000 ``ic07`` beside them,
  cuts and a damaged byte; then PIL's JPEG 2000 files of four modes as
  each PNG-or-JPEG-2000 entry type, reversible and irreversible.

Each file is read by PIL (``convert("RGBA")``, None where it raises, as
the JAX package's ``load_rgba``) and by the port (``load_rgba8``), and
tallied: equal, None in both, refused by the port
(``NotImplementedError``), or a difference. A refusal or a difference is
a fault unless ``utils/image.py``'s docstring names it.

Needs PIL (no card). ``python3 tools/bmp_icon_sweep.py --seed 0 --files
2000`` (about a minute) prints the tallies and the first cases that
differ.
"""

import argparse
import io
import os
import struct
import sys
import tempfile
import warnings
from collections import Counter

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))

import make_torch_fixtures as fx  # noqa: E402


def bmp(w, h, bits, compression, pixels, pal, colors=0, top=False,
        gap=0, dib=False) -> bytes:
    info = struct.pack("<IiiHHIIiiII", 40, w, -h if top else h, 1, bits,
                       compression, len(pixels), 0, 0, colors, 0)
    if dib:
        return info + pal + pixels
    offset = 14 + 40 + len(pal) + gap
    return (b"BM" + struct.pack("<IHHI", 0, 0, 0, offset) + info + pal
            + bytes(gap) + pixels)


def rle_file(rng) -> bytes:
    w = int(rng.choice([1, 2, 3, 4, 5, 6, 7, 8, 9, 33]))
    h = int(rng.integers(1, 6))
    rle4 = bool(rng.integers(0, 2))
    bits = 4 if rle4 else 8
    if rng.random() < 0.1:
        bits = int(rng.choice([1, 4, 8, 24]))
    ncol = {1: 2, 4: 16, 8: 256, 24: 0}[bits]
    colors = 0
    if rng.random() < 0.15:
        colors = ncol = int(rng.integers(1, 20))
    grey = rng.random() < 0.4
    if grey:
        values = (0, 255) if ncol == 2 else range(ncol)
        pal = b"".join(bytes((v, v, v, 0)) for v in values)
    else:
        pal = rng.integers(0, 256, 4 * ncol, np.uint8).tobytes()
    pk = bytearray()
    for _ in range(int(rng.integers(0, 4 * h + 6))):
        r = rng.random()
        if r < 0.45:
            pk += bytes((int(rng.integers(1, w + 3)),
                         int(rng.integers(0, 256))))
        elif r < 0.6:
            pk += b"\0\0"
        elif r < 0.63:
            pk += b"\0\1"
        elif r < 0.7:
            pk += b"\0\2" + bytes(rng.integers(0, 3, 4, np.uint8))
        else:
            n = int(rng.integers(3, w + 4))
            body = rng.integers(0, 16 if grey else 256,
                                (n + 1) // 2 if rle4 else n, np.uint8)
            pk += bytes((0, n)) + body.tobytes()
            if rng.random() < 0.7 and len(pk) % 2:
                pk += b"\0"
    if rng.random() < 0.2:
        pk = pk[:int(rng.integers(0, len(pk) + 1))]
    compression = 2 if rle4 else 1
    if rng.random() < 0.05:
        compression = 3 - compression
    return bmp(w, h, bits, compression, bytes(pk), pal, colors,
               rng.random() < 0.2, int(rng.integers(0, 2)),
               rng.random() < 0.33)


def dib(rng, w, h2, bits, pal, compression=0, pixels=None, top=False):
    stride = ((w * bits + 31) >> 3) & ~3
    if pixels is None:
        pixels = rng.integers(0, 256, stride * h2, np.uint8).tobytes()
    return struct.pack("<IiiHHIIiiII", 40, w, -h2 if top else h2, 1, bits,
                       compression, 0, 0, 0, 0, 0) + pal + pixels


def directory(frames, magic) -> bytes:
    out = magic + struct.pack("<H", len(frames))
    at, body = 6 + 16 * len(frames), b""
    for w, h, bits, payload, size in frames:
        out += struct.pack("<BBBBHHII", w % 256, h % 256, 0, 0, 1, bits,
                           len(payload) if size is None else size,
                           at + len(body))
        body += payload
    return out + body


def icon_files(rng):
    """An ICO and a CUR of one random bitmap (and maybe a second)."""
    w, h = int(rng.integers(1, 40)), int(rng.integers(1, 40))
    bits = int(rng.choice([1, 4, 8, 24, 32]))
    ncol = (1 << bits) if bits <= 8 else 0
    if rng.random() < 0.3 and bits <= 8:
        values = (0, 255) if ncol == 2 else range(ncol)
        pal = b"".join(bytes((v, v, v, 0)) for v in values)
    else:
        pal = rng.integers(0, 256, 4 * ncol, np.uint8).tobytes()
    top = rng.random() < 0.1
    h2 = 2 * h + (rng.random() < 0.1)
    if bits in (4, 8) and rng.random() < 0.3:
        rows = b"".join(bytes((w, int(rng.integers(0, 256)))) + b"\0\0"
                        for _ in range(h))
        body = dib(rng, w, h2, bits, pal, 1 if bits == 8 else 2, rows, top)
    else:
        body = dib(rng, w, h2, bits, pal, top=top)
    mask = rng.integers(0, 256, (w + 31) // 32 * 4 * h, np.uint8).tobytes()
    entry_bits = bits if rng.random() < 0.8 else int(
        rng.choice([0, 1, 8, 24, 32]))
    payload = body + (mask if entry_bits != 32 or rng.random() < 0.3
                      else b"")
    r, size = rng.random(), None
    if r < 0.1:
        size = len(payload) - int(rng.integers(1, 10))
    elif r < 0.2:
        size = len(payload) + int(rng.integers(1, 10))
    dw, dh = (w, h) if rng.random() < 0.8 else (
        int(rng.integers(1, 256)), int(rng.integers(1, 256)))
    frames = [(dw, dh, entry_bits, payload, size)]
    if rng.random() < 0.3:
        frames.append((int(rng.integers(1, 40)), int(rng.integers(1, 40)),
                       32, dib(rng, 8, 16, 32, b""), None))
    ico = directory(frames, b"\0\0\1\0")
    cursors = [(dw, dh, entry_bits, body, None)]
    if rng.random() < 0.4:
        cursors.append((int(rng.integers(1, 256)), int(rng.integers(1, 256)),
                        24, dib(rng, 5, 6, 24, b""), None))
    cur = directory(cursors, b"\0\0\2\0")
    return [f[:int(rng.integers(6, len(f) + 1))] if rng.random() < 0.2
            else f for f in (ico, cur)]


def block(kind: bytes, body: bytes) -> bytes:
    return kind + struct.pack(">I", 8 + len(body)) + body


def icns(*blocks) -> bytes:
    body = b"".join(blocks)
    return b"icns" + struct.pack(">I", 8 + len(body)) + body


def jpeg2000(px, **save) -> bytes:
    from PIL import Image
    out = io.BytesIO()
    Image.fromarray(px).save(out, "JPEG2000", **save)
    return out.getvalue()


RLE_TYPES = {b"is32": (16, b"s8mk"), b"il32": (32, b"l8mk"),
             b"ih32": (48, b"h8mk"), b"it32": (128, b"t8mk")}


def icns_file(rng) -> bytes:
    kind = sorted(RLE_TYPES)[int(rng.integers(0, 4))]
    side, mask_kind = RLE_TYPES[kind]
    px = rng.integers(0, 256, (side, side, 3), np.uint8)
    px[:, :side // 2] = px[:, :1] // 3 * 3
    if rng.random() < 0.2:
        body = (px.transpose(2, 0, 1) if rng.random() < 0.5 else px).tobytes()
    else:
        body = b"".join(fx.icns_rle(px[..., c]) for c in range(3))
    if kind == b"it32":
        body = (bytes(4) if rng.random() < 0.9 else b"\0\0\0\1") + body
    blocks = [block(kind, body)]
    if rng.random() < 0.6:
        mask = rng.integers(0, 256, side * side, np.uint8).tobytes()
        blocks.append(block(mask_kind, mask[:side * side - 5 * (
            rng.random() < 0.1)]))
    if rng.random() < 0.2:
        blocks.insert(0, block(b"is32", b"".join(
            fx.icns_rle(px[:16, :16, c]) for c in range(3))))
    if rng.random() < 0.15:
        blocks.append(block(b"ic07", jpeg2000(np.resize(px, (128, 128, 3)))))
    if rng.random() < 0.2:
        blocks.reverse()
    data = icns(*blocks)
    if rng.random() < 0.2:
        data = data[:int(rng.integers(8, len(data) + 1))]
    if rng.random() < 0.1:
        damaged = bytearray(data)
        damaged[int(rng.integers(8, len(data)))] = int(rng.integers(0, 256))
        data = bytes(damaged)
    return data


def jpeg2000_entries(rng):
    from PIL import Image
    for kind, side in ((b"ic07", 128), (b"ic08", 256), (b"ic09", 512),
                       (b"icp4", 16), (b"icp5", 32), (b"icp6", 64),
                       (b"ic11", 32), (b"ic12", 64)):
        for mode in ("L", "LA", "RGB", "RGBA"):
            px = rng.integers(0, 256, (side, side, 4), np.uint8)
            im = Image.fromarray(px, "RGBA").convert(mode)
            for save in ({}, {"no_jp2": True}, {"irreversible": True}):
                out = io.BytesIO()
                im.save(out, "JPEG2000", **save)
                yield f"{kind.decode()} {mode} {save}", icns(
                    block(kind, out.getvalue()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--files", type=int, default=2000,
                    help="random files of each kind")
    args = ap.parse_args()
    from PIL import Image
    from pathtracing_spectrum_tpu_torch.utils import image
    warnings.simplefilter("ignore")
    rng = np.random.default_rng(args.seed)
    tally, shown = Counter(), 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "x.bin")

        def held(name, data):
            nonlocal shown
            with open(path, "wb") as f:
                f.write(data)
            try:
                with Image.open(path) as im:
                    want = np.asarray(im.convert("RGBA"), np.uint8)
            except Exception:  # noqa: BLE001 (as the JAX package's load_rgba)
                want = None
            why = ""
            try:
                got = image.load_rgba8(path)
            except NotImplementedError as e:
                outcome, why = "refused", str(e)
            else:
                if want is None or got is None:
                    outcome = "none" if want is None and got is None \
                        else "differ"
                else:
                    outcome = "equal" if got.shape == want.shape and \
                        np.array_equal(got, want) else "differ"
            tally[name, outcome] += 1
            named = "grey palette" in why or "irreversible" in why
            if outcome in ("differ", "refused") and not named and shown < 20:
                shown += 1
                print("case:", name, outcome, why[-100:], data[:64].hex())

        for _ in range(args.files):
            held("rle", rle_file(rng))
            ico, cur = icon_files(rng)
            held("ico", ico)
            held("cur", cur)
            held("icns", icns_file(rng))
        for name, data in jpeg2000_entries(rng):
            held("icns jpeg2000", data)
    for (name, outcome), n in sorted(tally.items()):
        print(f"{name:14} {outcome:8} {n}")
    return 1 if any(o == "differ" for _, o in tally) else 0


if __name__ == "__main__":
    sys.exit(main())
