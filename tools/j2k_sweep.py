#!/usr/bin/env python3
"""The JPEG 2000 sweep: the port's writer and reader against PIL 12.1
(OpenJPEG 2.5.4) over a wider grid than the tier-1 tests can afford.

- The writer: ``write_image`` of L and RGB images at every pair of sides
  from ``SIDES`` (1 to 1024, around each power of two) up to 1024x1024,
  and a 5000x300 strip, noise or procedural content, as ``.j2k`` and
  ``.jp2`` by turns, byte for byte PIL's ``Image.save``.
- The reader: PIL's files of L, LA, RGB and RGBA at the pairs of sides up
  to 257, at 1024x1024 and 5000x300, at its defaults, with 16x16 and
  64x32 code-blocks and with PLT markers, as codestreams and JP2 files,
  read by the JAX package's ``load_rgba`` (PIL) and the port's.
- The save options: every combination of the reader's six steps beyond
  PIL's defaults (1 quality layers, by rate or by dB; 2 a progression
  order other than LRCP with precincts and a code-block size; 3 tiles at
  odd image and tile offsets; 4 the 9/7 transform; 5 the multiple
  component transform: RCT, or ICT with step 4; 6 signed samples), each
  in L, LA, RGB and RGBA at ``OPTION_SIZES`` pairs of sides from 1 to
  257, as codestreams and JP2 files by turns, read by both. PIL writes
  each file in a child process: OpenJPEG's 9/7 encoder asserts (and ends
  the process) on a tile line of one sample, which such a case tallies as
  PIL's own failure.

Each case is tallied: equal (bytes, or pixels as an int32 view), None in
both, refused by the port (``NotImplementedError``), or a difference.
A difference is a fault unless ``utils/image.py``'s docstring names it.

Needs PIL and the JAX package (no card). ``python3 tools/j2k_sweep.py``
(about seven minutes on one core; ``--part options`` about three and a
half) prints the tallies and each case that is not equal or None in
both; it exits 1 on any difference.
"""

import argparse
import io
import os
import sys
import tempfile
from collections import Counter
from itertools import product

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tools"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

SIDES = (1, 2, 3, 5, 8, 15, 16, 17, 31, 32, 33, 63, 64, 65, 127, 128, 129,
         255, 256, 257, 511, 512, 513, 1023, 1024)
STRIP = (5000, 300)
READ_SIDE_MAX = 257
READ_SAVES = ({}, {"codeblock_size": (16, 16)},
              {"codeblock_size": (64, 32)}, {"plt": True})
BANDS = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
OPTION_SIZES = 12         # side pairs for each combination and mode
ORDERS = ("RLCP", "RPCL", "PCRL", "CPRL")


def pixels(w: int, h: int, bands: int, seed: int) -> np.ndarray:
    """Noise for even seeds, ``procedural_rgb``'s ramps and hashed noise
    (its channels repeated past three) for odd ones."""
    import make_torch_fixtures as fx
    if seed % 2 == 0:
        px = np.random.default_rng(seed).integers(0, 256, (h, w, bands),
                                                  np.uint8)
    else:
        rgb = fx.procedural_rgb(w, h, seed)
        px = rgb[..., [i % 3 for i in range(bands)]]
    return np.ascontiguousarray(px[..., 0] if bands == 1 else px)


def writer_cases():
    sizes = [(w, h) for w, h in product(SIDES, SIDES) if w * h <= 1 << 20]
    for i, (w, h) in enumerate(sizes + [STRIP]):
        for mode in ("L", "RGB"):
            yield (w, h), mode, (".j2k", ".jp2")[i % 2], i


def reader_cases():
    sides = [s for s in SIDES if s <= READ_SIDE_MAX]
    sizes = list(product(sides, sides)) + [(1024, 1024), STRIP]
    for i, (w, h) in enumerate(sizes):
        for mode in BANDS:
            for j, save in enumerate(READ_SAVES):
                big = w * h > READ_SIDE_MAX ** 2
                if big and save:
                    continue
                yield (w, h), mode, save, ("j2k", "jp2")[(i + j) % 2], i


def option_save(steps: int, w: int, h: int, i: int) -> dict:
    """PIL's save options of the steps whose bits are set in ``steps``
    (bit 0 for step 1), varied by the case number ``i``."""
    save = {}
    if steps & 1:
        save.update({"quality_layers": [40, 10, 1]} if i % 2 else
                    {"quality_mode": "dB", "quality_layers": [30, 40]})
    if steps & 2:
        save["progression"] = ORDERS[i % 4]
        save["precinct_size"] = ((32, 32), (64, 64), (128, 128),
                                 (32, 64))[i // 4 % 4]
        save["codeblock_size"] = ((16, 16), (32, 32), (8, 64))[i % 3]
    if steps & 4:
        tw, th = max(8, w // 2 + i % 5), max(8, h // 3 + i % 7)
        tox, toy = 2 * (i % 4) + 1, 2 * (i % 3) + 1
        save["tile_size"] = (tw, th)
        save["tile_offset"] = (tox, toy)
        save["offset"] = (tox + 2 * (i % (tw // 2)), toy + 2 * (i % (th // 2)))
    if steps & 8:
        save["irreversible"] = True
    if steps & 16:
        save["mct"] = 1
    if steps & 32:
        save["signed"] = True
    return save


def option_cases():
    sides = [s for s in SIDES if s <= READ_SIDE_MAX]
    sizes = list(product(sides, sides))
    i = 0
    for steps in range(64):
        for m, mode in enumerate(BANDS):
            for k in range(OPTION_SIZES):
                w, h = sizes[(steps * 5 + m * 7 + k * 61) % len(sizes)]
                yield (w, h), mode, option_save(steps, w, h, i), steps, (
                    "j2k", "jp2")[i % 2], i
                i += 1


def pil_save(px: np.ndarray, mode: str, kind: str, save: dict):
    """PIL's file in a child process, or None where PIL fails (an
    exception, or OpenJPEG's assertion ending the child)."""
    from PIL import Image
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            out = io.BytesIO()
            Image.fromarray(px, mode).save(out, "JPEG2000",
                                           no_jp2=kind == "j2k", **save)
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


def read_both(path: str, tally: Counter, cases: list, case: tuple) -> None:
    from pathtracing_spectrum_tpu.utils import image as jimage
    from pathtracing_spectrum_tpu_torch.utils import image
    want = jimage.load_rgba(path)
    try:
        got = image.load_rgba(path)
    except NotImplementedError as e:
        tally["refused"] += 1
        cases.append(case + ("refused", str(e)[-80:]))
        return
    if (want is None) != (got is None):
        result = "none in one"
    elif want is None:
        result = "none in both"
    elif want.shape != got.shape or not np.array_equal(
            want.view(np.int32), got.view(np.int32)):
        result = "pixels differ"
    else:
        result = "equal"
    tally[result] += 1
    if result in ("none in one", "pixels differ"):
        cases.append(case + (result,))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--part", choices=("writer", "reader", "options",
                                           "all"), default="all")
    part = parser.parse_args().part
    from PIL import Image

    from pathtracing_spectrum_tpu_torch.utils import image
    tallies = {"writer": Counter(), "reader": Counter(), "options": Counter()}
    cases = []
    with tempfile.TemporaryDirectory() as tmp:
        for (w, h), mode, ext, seed in (writer_cases() if part in (
                "writer", "all") else ()):
            px = pixels(w, h, BANDS[mode], seed)
            ours, pils = (os.path.join(tmp, f"{who}{ext}")
                          for who in ("ours", "pils"))
            image.write_image(ours, px)
            Image.fromarray(px).save(pils)
            with open(ours, "rb") as a, open(pils, "rb") as b:
                kind = "equal" if a.read() == b.read() else "bytes differ"
            tallies["writer"][kind] += 1
            if kind != "equal":
                cases.append(("writer", kind, mode, f"{w}x{h}", ext))
        path = os.path.join(tmp, "x")
        for (w, h), mode, save, kind, seed in (reader_cases() if part in (
                "reader", "all") else ()):
            px = pixels(w, h, BANDS[mode], seed)
            out = io.BytesIO()
            Image.fromarray(px, mode).save(out, "JPEG2000",
                                           no_jp2=kind == "j2k", **save)
            with open(path, "wb") as f:
                f.write(out.getvalue())
            read_both(path, tallies["reader"], cases,
                      ("reader", mode, f"{w}x{h}", kind, save))
        for (w, h), mode, save, steps, kind, seed in (option_cases() if part in (
                "options", "all") else ()):
            data = pil_save(pixels(w, h, BANDS[mode], seed), mode, kind, save)
            if data is None:
                tallies["options"]["PIL fails"] += 1
                continue
            with open(path, "wb") as f:
                f.write(data)
            read_both(path, tallies["options"], cases,
                      ("options", "steps " + "+".join(
                          str(b + 1) for b in range(6) if steps >> b & 1),
                       mode,
                       f"{w}x{h}", kind, save))
    for who, tally in tallies.items():
        if tally:
            print(who, dict(tally))
    for c in cases:
        print(*c)
    faults = sum(t[k] for t in tallies.values()
                 for k in ("bytes differ", "none in one", "pixels differ"))
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
