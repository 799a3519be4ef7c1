#!/usr/bin/env python3
"""Hold the port's ZSTD strip decoder (``utils/codecs.py::tiff_zstd``,
``csrc/zstd_decode.cpp``) to libzstd 1.5.7 on many frames, valid and
damaged.

libzstd is ``zstandard``'s (its bundled 1.5.7, the version PIL's libtiff
links), driven as libtiff 4.7's ZSTDDecode drives it:
``stream_reader(strip, read_across_frames=False).read(nbytes)`` calls
``ZSTD_decompressStream`` into the strip's buffer until the frame ends,
the input is used up or the buffer is full; an error, or fewer than
``nbytes`` bytes, fails the strip. Every ``--pil-every``-th case is also
wrapped as a one-strip TIFF and read by PIL (``Image.open(...).convert(
"RGBA")``) and by the port's ``image.load_rgba8``.

The frames: every level from -7 to 22, and level 19 in long mode, each
with and without a content size and a checksum (``zstandard``'s
one-shot compressor) or streamed (its ``compressobj``, as libtiff writes
them), over seven kinds of data (zeros, noise, text, runs, a gradient, a
random walk, a skewed alphabet) at sizes from 1 byte to 300 KB, so that
literals are raw, RLE, Huffman over one and four streams and treeless,
sequences predefined, RLE, FSE-coded and repeated, and blocks raw, RLE
and compressed, one to three a frame. Each frame is decoded whole and
with the strip 1-3 bytes shorter than its content (a frame longer than
its strip), cut at ``--cuts`` places and damaged by ``--flips`` single
bit flips.

Prints the counts of each kind of case (``equal``: the same bytes;
``both_fail``; ``differ``) and the first differences; exits 1 on any
difference. Run from the repository root:

    python3 tools/zstd_sweep.py --seed 26 --cuts 8 --flips 60 2>/dev/null

(~4 min on an 8-core box at those settings; PIL's libtiff prints its
errors on stderr). Needs ``zstandard`` and PIL; the port imports
neither.
"""

import argparse
import collections
import io
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

LEVELS = list(range(-7, 23))
SIZES = (1, 7, 100, 1000, 5000, 70000, 140000, 300000)


def data_kinds(n: int, seed: int):
    """(name, n bytes) of seven kinds of content."""
    r = np.random.default_rng(seed)
    yield "zeros", bytes(n)
    yield "noise", r.integers(0, 256, n, np.uint8).tobytes()
    text = b"the quick brown fox %d jumps over the lazy dog; " % seed
    yield "text", (text * (n // len(text) + 1))[:n]
    yield "runs", np.repeat(r.integers(0, 256, n // 16 + 1, np.uint8),
                            16)[:n].tobytes()
    yield "gradient", (np.arange(n) * 7 // 13 % 256).astype(
        np.uint8).tobytes()
    yield "walk", (np.cumsum(r.integers(-3, 4, n)) % 256).astype(
        np.uint8).tobytes()
    p = np.r_[np.full(8, 0.12), np.full(248, 0.04 / 248)]
    yield "skewed", r.choice(256, n, p=p).astype(np.uint8).tobytes()


def frames(zstd, data: bytes, level: int, variant: int):
    """A frame of ``data``: variant 0 streamed (no content size, as
    libtiff), 1 one-shot with its content size, 2 with a checksum too;
    level 23 is level 19 in long mode."""
    if variant == 0:
        obj = zstd.ZstdCompressor(level=min(level, 22)).compressobj()
        half = len(data) // 2
        return obj.compress(data[:half]) + obj.compress(data[half:]) + \
            obj.flush()
    if level == 23:
        params = zstd.ZstdCompressionParameters.from_level(
            19, enable_ldm=True, window_log=27, write_checksum=variant == 2)
        return zstd.ZstdCompressor(compression_params=params).compress(data)
    return zstd.ZstdCompressor(level=level, write_content_size=True,
                               write_checksum=variant == 2).compress(data)


def libtiff_zstd(zstd, strip: bytes, nbytes: int):
    """libzstd as libtiff's ZSTDDecode drives it: the bytes, or None."""
    try:
        out = zstd.ZstdDecompressor().stream_reader(
            strip, read_across_frames=False).read(nbytes)
    except zstd.ZstdError:
        return None
    return out if len(out) == nbytes else None


def port_zstd(codecs, strip: bytes, nbytes: int):
    try:
        return codecs.tiff_zstd(strip, nbytes).tobytes()
    except codecs.BrokenData:
        return None


def pil_tiff(ti, strip: bytes, nbytes: int):
    """(PIL's RGBA8, the port's) of ``strip`` as a grey one-strip TIFF
    ``nbytes`` wide."""
    from PIL import Image
    from pathtracing_spectrum_tpu_torch.utils import image
    data = ti.tiff_bytes(np.zeros((1, nbytes, 1), np.uint8),
                         compression=50000, chunks=[strip])
    try:
        with Image.open(io.BytesIO(data)) as im:
            want = np.asarray(im.convert("RGBA"), np.uint8)
    except Exception:  # noqa: BLE001 (PIL's exceptions, as load_rgba)
        want = None
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"zstd_sweep_{os.getpid()}.tif")
    with open(path, "wb") as f:
        f.write(data)
    try:
        got = image.load_rgba8(path)
    finally:
        os.remove(path)
    return want, got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=26)
    ap.add_argument("--cuts", type=int, default=8)
    ap.add_argument("--flips", type=int, default=60)
    ap.add_argument("--pil-every", type=int, default=50)
    args = ap.parse_args()
    import zstandard as zstd
    import torch_images as ti
    from pathtracing_spectrum_tpu_torch.utils import codecs
    rng = np.random.default_rng(args.seed)
    counts = collections.Counter()
    differ = []
    case = 0

    def held(kind: str, strip: bytes, nbytes: int, what) -> None:
        nonlocal case
        case += 1
        want = libtiff_zstd(zstd, strip, nbytes)
        got = port_zstd(codecs, strip, nbytes)
        verdict = ("equal" if want == got and want is not None
                   else "both_fail" if want == got else "differ")
        counts[f"{kind} {verdict}"] += 1
        if verdict == "differ" and len(differ) < 20:
            differ.append((kind, what, want is None, got is None))
        if case % args.pil_every == 0 and nbytes <= 1 << 16:
            pil, port = pil_tiff(ti, strip, nbytes)
            same = (pil is None) == (port is None) and (
                pil is None or np.array_equal(pil, port))
            counts[f"pil {'equal' if same else 'differ'}"] += 1
            if not same and len(differ) < 20:
                differ.append(("pil " + kind, what, pil is None,
                               port is None))

    for n in SIZES:
        for name, data in data_kinds(n, n + args.seed):
            for level in LEVELS + [23]:
                for variant in range(3):
                    frame = frames(zstd, data, level, variant)
                    what = (n, name, level, variant)
                    held("valid", frame, n, what)
                    if n > 3:
                        held("longer", frame, n - 1 - int(
                            rng.integers(0, 3)), what)
                    for cut in rng.integers(0, len(frame), args.cuts):
                        held("cut", frame[:int(cut)], n, what + (int(cut),))
                    for _ in range(args.flips):
                        damaged = bytearray(frame)
                        i = int(rng.integers(0, len(frame)))
                        damaged[i] ^= 1 << int(rng.integers(0, 8))
                        held("flip", bytes(damaged), n, what + (i,))
    for key in sorted(counts):
        print(f"{key}: {counts[key]}")
    for d in differ:
        print("DIFFER", d)
    return 1 if any(k.endswith("differ") for k in counts) else 0


if __name__ == "__main__":
    sys.exit(main())
