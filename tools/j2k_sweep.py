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

Each case is tallied: equal (bytes, or pixels as an int32 view), None in
both, refused by the port (``NotImplementedError``), or a difference.
A difference is a fault unless ``utils/image.py``'s docstring names it.

Needs PIL and the JAX package (no card). ``python3 tools/j2k_sweep.py``
(about four minutes on one core) prints the tallies and each case that is
not equal or None in both.
"""

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


def main() -> int:
    from PIL import Image

    from pathtracing_spectrum_tpu.utils import image as jimage
    from pathtracing_spectrum_tpu_torch.utils import image
    tallies = {"writer": Counter(), "reader": Counter()}
    cases = []
    with tempfile.TemporaryDirectory() as tmp:
        for (w, h), mode, ext, seed in writer_cases():
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
        for (w, h), mode, save, kind, seed in reader_cases():
            px = pixels(w, h, BANDS[mode], seed)
            out = io.BytesIO()
            Image.fromarray(px, mode).save(out, "JPEG2000",
                                           no_jp2=kind == "j2k", **save)
            with open(path, "wb") as f:
                f.write(out.getvalue())
            want = jimage.load_rgba(path)
            case = ("reader", mode, f"{w}x{h}", kind, save)
            try:
                got = image.load_rgba(path)
            except NotImplementedError as e:
                tallies["reader"]["refused"] += 1
                cases.append(case + ("refused", str(e)[-80:]))
                continue
            if (want is None) != (got is None):
                result = "none in one"
            elif want is None:
                result = "none in both"
            elif want.shape != got.shape or not np.array_equal(
                    want.view(np.int32), got.view(np.int32)):
                result = "pixels differ"
            else:
                result = "equal"
            tallies["reader"][result] += 1
            if result in ("none in one", "pixels differ"):
                cases.append(case + (result,))
    for who, tally in tallies.items():
        print(who, dict(tally))
    for c in cases:
        print(*c)
    return 0


if __name__ == "__main__":
    sys.exit(main())
