#!/usr/bin/env python3
"""Hold the port's FLI/FLC, PhotoCD and IPTC readers
(``utils/fli_pcd_iptc.py``, ``csrc/fli_decode.cpp``) to PIL 12.1 on many
files, valid and damaged, and its PhotoYCC conversion on every triple.

Each case is written to a file and read as the JAX package reads a
texture, ``PIL.Image.open(path).convert("RGBA")`` with any exception
None, and by the port's ``image.load_rgba8``.

The files: FLI and FLC headers drawn at random (either magic, flags 0, 1
or 3, 0 to 3 frames, widths 1 to 23), a colour chunk of 4 or 11 in
random packets (skips, counts of 0, indices past 255) or none, a prefix
chunk now and then, frames of 1 to 4 subchunks (BRUN, LC from a random
line, SS2 with line skips, BLACK, COPY whole or short, a postage stamp, a
colour chunk, an unknown type), a second frame; PhotoCD files of random
luma and chroma at orientations 0-255, cut at the header's and the
body's edges and at random chunks; IPTC records of random fields in a
random order (the 2-byte and the 1-4 byte long length forms, the size-0
form, a length byte past 132, fields missing or repeated, other
records), ``L``, ``RGB`` and
``CMYK`` modes with and without a band, raw data or PIL's JPEG or PNG
under compression 5, the image data in one or more fields. Every FLI and
IPTC file is also cut at every byte (``--cuts 0``) or at ``--cuts``
places, and each file damaged by ``--flips`` single bit flips. Then
``--ycc`` PhotoCD files that hold every (Y, Cb, Cr) triple (98,304 chroma
pairs of 4 luma samples each: 43 files for all 2^24) against PIL's
decode of them.

Prints the counts of each kind of case (``equal``: the same image;
``both_none``; ``refused``: the port raised ``NotImplementedError``;
``differ``) and the first differences; exits 1 on any difference. Run
from the repository root:

    python3 tools/fli_pcd_iptc_sweep.py --seed 29 --files 300 --cuts 0 \\
        --flips 24

Needs PIL; the port imports none of it.
"""

import argparse
import collections
import importlib.util
import io
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

def _index(r, w: int, h: int) -> np.ndarray:
    index = r.integers(0, 256, (h, w), np.uint8)
    index[:, :int(r.integers(0, w + 1))] = int(r.integers(0, 256))
    return index


def _colour(r) -> bytes:
    kind = int(r.choice([4, 11]))
    packets, total = [], 0
    for _ in range(int(r.integers(1, 4))):
        skip = int(r.choice([0, 0, 0, 1, 7, 60, 250]))
        count = int(r.choice([1, 5, 30, 64, 256] if r.random() < 0.1
                             else [1, 5, 30, 64]))
        packets.append((skip, count))
        total += count
    pal = r.integers(0, 256 if kind == 4 or r.random() < 0.2 else 64,
                     (total, 3), np.uint8)
    return fx.fli_chunk(kind, fx.fli_colour(pal, packets))


def _subchunk(r, index: np.ndarray) -> bytes:
    h, w = index.shape
    pick = int(r.integers(0, 16)) % 9
    if pick == 7 and r.random() < 0.5:
        pick = 0
    if pick == 0:
        return fx.fli_chunk(15, fx.fli_brun(index))
    if pick == 1:                         # its lines now and then one
        y0 = int(r.integers(0, h))        # past the image
        past = r.random() < 0.2
        y1 = h if past else int(r.integers(y0, h + 1))
        return fx.fli_chunk(12, fx.fli_lc(index[y0:y1], y0 + past, int(
            r.integers(1, 8))))
    if pick == 2:
        if r.random() < 0.2:              # a packet's pairs past the line
            return fx.fli_chunk(7, struct.pack("<HHBB", 1, 1, int(
                r.integers(0, w)), 256 - int(r.integers(1, 8))) + bytes(8))
        return fx.fli_chunk(7, fx.fli_ss2(index[:, :w - (w % 2) * int(
            r.random() < 0.3)], int(r.integers(1, 4))))
    if pick == 3:
        return fx.fli_chunk(13, b"")
    if pick == 4:
        data = index.tobytes()
        return fx.fli_chunk(16, data if r.random() < 0.8 else data[:-1])
    if pick == 5:
        return fx.fli_chunk(18, r.integers(0, 256, int(r.integers(0, 20)),
                                           np.uint8).tobytes())
    if pick == 6:
        return _colour(r)
    if pick == 7:
        return fx.fli_chunk(int(r.choice([0, 5, 14, 17, 99])), bytes(6))
    return fx.fli_chunk(15, fx.fli_brun(index))


def fli_file(r) -> bytes:
    w, h = int(r.integers(1, 24)), int(r.integers(1, 10))
    index = _index(r, w, h)
    chunks = [_colour(r)] if r.random() < 0.7 else []
    chunks += [_subchunk(r, index) for _ in range(int(r.integers(1, 4)))]
    if r.random() < 0.5:                  # a last chunk of 10 bytes or more
        chunks.append(fx.fli_chunk(18, bytes(4)))
    if r.random() < 0.1:                  # an advance of 0 or past the end
        at = int(r.integers(0, len(chunks)))
        chunks[at] = struct.pack("<I", int(r.choice([0, 1 << 20]))) + \
            chunks[at][4:]
    frame = fx.fli_frame(chunks)
    if len(frame) % 2 and r.random() < 0.5:   # padded, the pad missing
        frame = struct.pack("<I", len(frame) + 1) + frame[4:]
    frames = [frame]
    if r.random() < 0.3:
        frames.append(fx.fli_frame([_subchunk(r, index)]))
    prefix = (fx.fli_chunk(0xF100, bytes(int(r.integers(0, 12))))
              if r.random() < 0.1 else b"")
    n_frames = len(frames) if r.random() < 0.9 else int(r.integers(0, 4))
    return fx.fli_bytes(w, h, frames, int(r.choice([0xAF11, 0xAF12])),
                        int(r.choice([0, 3, 3, 1])), n_frames, prefix)


def _pil_body(r, mode: str, w: int, h: int) -> bytes:
    from PIL import Image
    px = r.integers(0, 256, (h, w) if mode == "L" else (h, w, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, str(r.choice(["JPEG", "PNG"])))
    return buf.getvalue()


def iptc_file(r) -> bytes:
    w, h = int(r.integers(1, 20)), int(r.integers(1, 8))
    layers, component = [(1, 0), (3, 1), (4, 1), (1, 1), (3, 0)][
        int(r.choice([0, 0, 0, 1, 1, 2, 2, 3, 4]))]
    compression = int(r.choice([1, 1, 1, 5, 5, 5, 3]))
    if compression == 5:
        data = _pil_body(r, "L" if r.random() < 0.85 else "RGB",
                         w if r.random() < 0.8 else w + 2, h)
    else:
        data = r.integers(0, 256, w * h + int(r.integers(-2, 3)),
                          np.uint8).tobytes()

    def form(n: int = 4) -> int:
        """A length form that holds ``n``."""
        return int(r.choice([f for f in (0, 0, 0, 1, 2, 4) if n < (
            32768 if f == 0 else 256 ** f)]))

    fields = [fx.iptc_field(3, 20, struct.pack(">I", w)[
        -int(r.choice([2, 4])):], form()),
              fx.iptc_field(3, 30, struct.pack(">H", h), form()),
              fx.iptc_field(3, 60, bytes([layers, component]), form()),
              fx.iptc_field(3, 120, bytes([compression]), form())]
    if layers > 1 and r.random() < 0.8:
        fields.append(fx.iptc_field(3, 65, bytes([int(r.choice(
            [0, 1, 2, 3, 4, 5] if r.random() < 0.2 else [1, 2, 3]))]),
                                    form()))
    if r.random() < 0.3:
        fields.append(fx.iptc_field(int(r.choice([1, 2, 9, 240])),
                                    int(r.integers(0, 256)),
                                    bytes(int(r.integers(0, 9))), form()))
    if r.random() < 0.1:
        fields.append(b"\x1c\x02\x07\x80\x00")         # a size-0 field
    if r.random() < 0.05:                       # a length byte past 132
        fields.append(b"\x1c\x02\x07\x85\x00" + bytes(5))
    if r.random() < 0.05:
        fields.pop(int(r.integers(0, len(fields))))
    if r.random() < 0.05:
        fields.append(fields[int(r.integers(0, len(fields)))])
    order = r.permutation(len(fields))
    head = b"".join(fields[i] for i in order)
    parts = np.array_split(np.frombuffer(data, np.uint8),
                           int(r.integers(1, 4)))
    body = b"".join(fx.iptc_field(8, 10, p.tobytes(), form(p.size))
                    for p in parts)
    tail = fx.iptc_field(2, 5, b"end") if r.random() < 0.2 else b""
    return head + body + tail


def pcd_file(r) -> bytes:
    luma = r.integers(0, 256, (512, 768), np.uint8)
    cb = r.integers(0, 256, (256, 384), np.uint8)
    cr = r.integers(0, 256, (256, 384), np.uint8)
    data = bytearray(fx.pcd_bytes(luma, cb, cr, int(r.integers(0, 256))))
    data[2056:2060] = r.integers(0, 256, 4, np.uint8).tobytes()
    return bytes(data)


def pcd_cuts(r, n: int):
    """Where a PhotoCD file is cut: the header's edges, the body's, and
    random chunk edges."""
    edges = [0, 2047, 2051, 2052, 3586, 3587, fx.PCD_OFFSET - 1,
             fx.PCD_OFFSET, fx.PCD_OFFSET + 1, n - 1, n]
    chunks = r.integers(0, 256, 4) * 2304 + fx.PCD_OFFSET
    return edges + [int(c) + d for c in chunks for d in (-1, 0, 1)]


def ycc_files():
    """PhotoCD files holding every (Y, Cb, Cr) triple: chroma slot s (of
    65,536 x 64) holds the pair s % 65,536 under the lumas 4 (s // 65,536)
    to 4 (s // 65,536) + 3, in the 2x2 block that shares it."""
    per = 256 * 384
    slots = 65536 * 64
    for f in range(-(-slots // per)):
        s = np.arange(f * per, (f + 1) * per) % slots
        pair, group = s % 65536, s // 65536
        cb = (pair >> 8).astype(np.uint8).reshape(256, 384)
        cr = (pair & 255).astype(np.uint8).reshape(256, 384)
        base = (group * 4).reshape(256, 384)
        luma = np.empty((256, 2, 384, 2), np.int64)
        luma[:, 0, :, 0], luma[:, 0, :, 1] = base, base + 1
        luma[:, 1, :, 0], luma[:, 1, :, 1] = base + 2, base + 3
        yield fx.pcd_bytes(luma.reshape(512, 768).astype(np.uint8), cb, cr)


KINDS = {"FLI": fli_file, "IPTC": iptc_file}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=29)
    ap.add_argument("--files", type=int, default=300,
                    help="random FLI and IPTC files of each kind")
    ap.add_argument("--pcd-files", type=int, default=20)
    ap.add_argument("--cuts", type=int, default=0,
                    help="cuts of each FLI and IPTC file (0: every byte)")
    ap.add_argument("--flips", type=int, default=24)
    ap.add_argument("--ycc", type=int, default=43,
                    help="PhotoCD files of every YCC triple (43: all)")
    args = ap.parse_args()
    from pathtracing_spectrum_tpu_torch.utils import image
    r = np.random.default_rng(args.seed)
    counts, differ = collections.Counter(), []
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

        def flips(kind: str, i: int, data: bytes, lo: int = 0,
                  hi: int = 0) -> None:
            for _ in range(args.flips):
                damaged = bytearray(data)
                at = int(r.integers(lo, hi or len(data)))
                damaged[at] ^= 1 << int(r.integers(0, 8))
                held(kind + " flip", bytes(damaged), (i, at))

        for kind, make in KINDS.items():
            for i in range(args.files):
                data = make(r)
                held(kind, data, (i, "whole"))
                cuts = (range(len(data)) if args.cuts == 0 else
                        r.integers(0, len(data) + 1, args.cuts))
                for cut in cuts:
                    held(kind + " cut", data[:int(cut)], (i, int(cut)))
                flips(kind, i, data)
        for i in range(args.pcd_files):
            data = pcd_file(r)
            held("PCD", data, (i, "whole"))
            for cut in pcd_cuts(r, len(data)):
                held("PCD cut", data[:cut], (i, cut))
            for at in (2048, 2049, 2050, 2051, 3586):  # the marker and the
                for bit in range(8):                   # orientation
                    damaged = bytearray(data)
                    damaged[at] ^= 1 << bit
                    held("PCD header flip", bytes(damaged), (i, at))
            flips("PCD header", i, data, 2040, 3600)
            flips("PCD", i, data, fx.PCD_OFFSET)
        for i, data in enumerate(ycc_files()):
            if i == args.ycc:
                break
            held("PCD of every YCC triple", data, (i, "whole"))
    for key in sorted(counts):
        print(f"{key}: {counts[key]}")
    for d in differ:
        print("DIFFER", d)
    n = sum(v for k, v in counts.items() if k.endswith("differ"))
    print(f"{sum(counts.values())} cases, {n} differ")
    return 1 if n else 0


if __name__ == "__main__":
    sys.exit(main())
