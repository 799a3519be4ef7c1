#!/usr/bin/env python3
"""Hold the port's Sun raster, GIMP brush, MSP, XBM and XPM readers
(``utils/bitmaps.py``) to PIL 12.1 on many files, valid and damaged.

Each case is written to a file and read as the JAX package reads a
texture, ``PIL.Image.open(path).convert("RGBA")`` with any exception
None, and by the port's ``image.load_rgba8``.

The files: Sun raster headers drawn at random (depth 1, 4, 8, 24, 32 and
others; types 0-6; colour map types 0-2 and lengths 0 to past 1,024;
widths 1 to 19; the length field, which GBR's plugin reads as a depth, 0
to 8; raw rows exact, short, long) and run-length streams of 0x80, 0x00
and other bytes; GBR headers of both versions (header sizes 19 to 40,
depths 0 to 5, ``GIMP`` or not, data short or long); MSP ``DanM`` files
and ``LinS`` row maps (fills, literals past a row's end, rows of length
0, rows and row maps cut short, bad checksums); XBM texts (hotspots,
``0x`` values of 1, 2 and 4 digits, ``0X``, an ``x`` in a comment,
leading white space, ``_bits[]`` past 512 bytes); XPM texts (1-3
character keys, 1 to 300 colours, ``#RGB``, ``#RRGGBB`` and 48-bit
colours, names, ``None``, other keys before ``c``, lines without their
comma, pixel lines split, joined, commented and cut); each also cut at
every byte (``--cuts 0``) or at ``--cuts`` places, and damaged by
``--flips`` single bit flips.

Prints the counts of each kind of case (``equal``: the same image;
``both_none``; ``refused``: the port raised ``NotImplementedError``;
``differ``) and the first differences; exits 1 on any difference. Run
from the repository root:

    python3 tools/bitmap_sweep.py --seed 28 --files 300 --cuts 0 --flips 24

Needs PIL; the port imports none of it.
"""

import argparse
import collections
import importlib.util
import os
import struct
import sys
import tempfile
import warnings

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

_spec = importlib.util.spec_from_file_location(
    "make_torch_fixtures", os.path.join(HERE, "tools",
                                        "make_torch_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)


def pil_rgba8(path: str):
    """The JAX package's reading: None on any exception."""
    from PIL import Image
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with Image.open(path) as im:
                return np.asarray(im.convert("RGBA"), np.uint8)
    except Exception:  # noqa: BLE001 (the JAX package's rule)
        return None


# ---- random files -----------------------------------------------------------

def sun_file(r) -> bytes:
    depth = int(r.choice([1, 4, 8, 8, 24, 32, 2, 16]))
    kind = int(r.choice([0, 1, 1, 3, 4, 5, 6]))
    w, h = int(r.integers(1, 20)), int(r.integers(1, 6))
    length = int(r.choice([0, 0, 0, 0, 1, 3, 4, 6, 48, 768, 770, 771,
                           1025]))
    map_type = int(r.choice([1, 1, 1, 0, 2]))
    row = (w * depth + 15) // 16 * 2
    extra = int(r.integers(-4, 5)) if r.random() < 0.3 else 0
    data = r.integers(0, 256, max(0, h * row + extra), np.uint8).tobytes()
    return struct.pack(">8I", 0x59A66A95, w, h, depth, int(r.integers(0, 9)),
                       kind, map_type, length) + fx.hashed_bytes(
        length, w).tobytes() + data


def sun_rle_file(r) -> bytes:
    depth = int(r.choice([1, 4, 8, 8, 24, 32]))
    w, h = int(r.integers(1, 12)), int(r.integers(1, 5))
    need = h * ((w * depth + 7) // 8)
    if r.random() < 0.5:
        px = r.integers(0, 3, need) * 0x40
        stream = fx.sun_rle_bytes(px.astype(np.uint8).tobytes())
    else:
        stream = r.choice(np.array([0x80, 0x80, 0, 1, 255], np.uint8),
                          int(r.integers(0, 3 * need + 4))).tobytes()
    length = int(r.choice([0, 0, 6, 48]))
    return struct.pack(">8I", 0x59A66A95, w, h, depth, 0, 2, 1,
                       length) + bytes(length) + stream


def gbr_file(r) -> bytes:
    version = int(r.choice([1, 2]))
    w, h = int(r.integers(0, 7)), int(r.integers(1, 7))
    depth = int(r.choice([1, 4, 4, 0, 2, 5]))
    size = int(r.choice([19, 20, 24, 27, 28, 29, 40]))
    head = struct.pack(">5I", size, version, w, h, depth)
    if version == 2:
        head += (b"GIMP" if r.random() < 0.9 else b"GIMQ") + struct.pack(
            ">I", 25)
    n = max(0, size - len(head)) + w * h * max(depth, 1) + int(
        r.integers(-3, 4))
    return head + r.integers(0, 256, max(n, 0), np.uint8).tobytes()


def msp_file(r) -> bytes:
    w, h = int(r.integers(1, 30)), int(r.integers(1, 6))
    if r.random() < 0.3:
        data = fx.msp_bytes(r.integers(0, 2, (h, w)).astype(np.uint8))
    elif r.random() < 0.5:
        data = fx.msp_bytes(r.integers(0, 2, (h, w)).astype(np.uint8), True)
    else:
        rows = []
        for _ in range(h):
            row = b""
            for _ in range(int(r.integers(0, 5))):
                if r.random() < 0.5:
                    row += bytes([0, int(r.integers(0, 6)),
                                  int(r.integers(0, 256))])
                else:
                    c = int(r.integers(1, 6))
                    row += bytes([c]) + r.integers(0, 256, c,
                                                   np.uint8).tobytes()
            rows.append(row[:len(row) - (r.random() < 0.1)])
        data = (fx.msp_header(b"LinS", w, h)
                + struct.pack(f"<{h}H", *(len(x) for x in rows))
                + b"".join(rows))
    if r.random() < 0.05:                       # a bad checksum
        data = data[:24] + b"\1" + data[25:]
    return data


def xbm_file(r) -> bytes:
    w, h = int(r.integers(0, 20)), int(r.integers(0, 4))
    head = b"#define im_width %d\n#define im_height %d\n" % (w, h)
    if r.random() < 0.3:
        head += b"#define im_x_hot 1\n#define im_y_hot 2\n"
    head += b"static char im_bits[] = {\n"
    forms = [b"0x%02x", b"0x%x", b"0X%02x", b"/* x */ 0x%02x", b"0x%04x",
             b"xx%02x", b"0x%02X"]
    n = (w + 7) // 8 * h + int(r.integers(-2, 3))
    values = b", ".join(forms[int(r.integers(0, len(forms)))] % int(
        r.integers(0, 256)) for _ in range(max(n, 0)))
    data = head + values + b"};\n"
    if r.random() < 0.2:
        data = b"  \n" * int(r.integers(1, 4)) + data
    if r.random() < 0.1:
        data = data.replace(b"static", b" " * 480 + b"static")
    return data


KEY_CHARS = np.frombuffer(fx.XPM_CHARS + b"+@$%&*=-;:<>", np.uint8)


def xpm_file(r) -> bytes:
    cpp = int(r.choice([1, 1, 2, 2, 3]))
    ncolours = int(r.choice([1, 2, 3, 5, 12, 257, 300]))
    w, h = int(r.integers(0, 7)), int(r.integers(0, 5))
    keys = []
    bad = r.random() < 0.3                      # damage the text
    while len(keys) < ncolours:
        k = bytes(r.choice(KEY_CHARS, cpp))
        if k not in keys or r.random() < 0.02:
            keys.append(k)
    lines = [b'"%d %d %d %d",' % (w, h, ncolours, cpp)]
    none = None
    for k in keys:
        u = r.random()
        if u < (0.15 if ncolours <= 12 else 0.01):
            spec, none = b"c None", k
        elif u < 0.05 and bad:
            spec = b"c white"
        elif u < 0.06 and bad:
            spec = b"m #000"
        else:
            spec = b"c #" + [b"%06X", b"%03X", b"%012X", b"%x"][int(
                r.integers(0, 4))] % int(r.integers(0, 1 << 24))
        if r.random() < 0.1:
            spec = b"s x m #000000 " + spec
        lines.append(b'"' + k + b" " + spec + b'"'
                     + (b"," if r.random() < 0.97 or not bad else b""))
    rows = [b"/* pixels */"] if r.random() < 0.5 else []
    for _ in range(max(0, h + int(r.integers(-1, 2)) * bad)):
        px = [keys[int(j)] for j in r.integers(0, len(keys), w)]
        if none is not None and r.random() < 0.05:
            px[:1] = [none]
        row = b"".join(px)
        if r.random() < 0.05 and bad:
            row = row[:-1]
        if r.random() < 0.1:
            rows.append(b"/* a comment */")
        if r.random() < 0.1:
            rows.append(b"/* pixels */")
        if r.random() < 0.1:
            cut = int(r.integers(0, len(row) + 1))
            rows += [b'"' + row[:cut] + b'",', b'"' + row[cut:] + b'",']
        else:
            rows.append(b'"' + row + b'",')
    return (b"/* XPM */\nstatic char *x[] = {\n"
            + b"".join(x + b"\n" for x in lines + rows) + b"};\n")


KINDS = {"sun": sun_file, "sun_rle": sun_rle_file, "gbr": gbr_file,
         "msp": msp_file, "xbm": xbm_file, "xpm": xpm_file}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=28)
    ap.add_argument("--files", type=int, default=300,
                    help="random files of each kind")
    ap.add_argument("--cuts", type=int, default=0,
                    help="cuts of each file (0: at every byte)")
    ap.add_argument("--flips", type=int, default=24)
    args = ap.parse_args()
    from pathtracing_spectrum_tpu_torch.utils import image
    r = np.random.default_rng(args.seed)
    counts = collections.Counter()
    differ = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "case.bin")

        def held(kind: str, data: bytes, what) -> None:
            with open(path, "wb") as f:
                f.write(data)
            want = pil_rgba8(path)
            try:
                got = image.load_rgba8(path)
            except NotImplementedError:       # a format or flavour the
                counts[f"{kind} refused as {image._sniff(data)}"] += 1
                return                        # port does not decode
            if want is None or got is None:
                verdict = "both_none" if want is None and got is None \
                    else "differ"
            else:
                verdict = ("equal" if want.shape == got.shape
                           and np.array_equal(want, got) else "differ")
            counts[f"{kind} {verdict}"] += 1
            if verdict == "differ" and len(differ) < 20:
                differ.append((kind, what, data[:96]))

        for kind, make in KINDS.items():
            for i in range(args.files):
                data = make(r)
                held(kind, data, (i, "whole"))
                cuts = (range(len(data)) if args.cuts == 0 else
                        r.integers(0, len(data) + 1, args.cuts))
                for cut in cuts:
                    held(kind + " cut", data[:int(cut)], (i, int(cut)))
                for _ in range(args.flips):
                    damaged = bytearray(data)
                    at = int(r.integers(0, len(data)))
                    damaged[at] ^= 1 << int(r.integers(0, 8))
                    held(kind + " flip", bytes(damaged), (i, at))
    for key in sorted(counts):
        print(f"{key}: {counts[key]}")
    for d in differ:
        print("DIFFER", d)
    n = sum(v for k, v in counts.items() if k.endswith("differ"))
    print(f"{sum(counts.values())} cases, {n} differ")
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
