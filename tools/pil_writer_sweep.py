#!/usr/bin/env python3
"""The PIL-writer sweep: every file PIL's writers make from 13 modes at
1x1 to 64x64, read by the JAX package's ``load_rgba`` (PIL) and the
port's, and tallied: equal arrays, None in both, refused by the port
(``NotImplementedError``), or a difference (None in one only, or other
pixels).

Writers: PNG, BMP, TGA (raw and RLE), GIF, PPM, WebP (lossless and
lossy), TIFF under 9 compressions (none, LZW, Deflate, PackBits, JPEG,
CCITT RLE, Group 3, Group 4, RLEW), JPEG 4 ways, IM, SGI and PCX; and
for mode ``1`` the CCITT settings the TIFF plugin takes through
``tiffinfo``: Group 3 with T4Options 0, 1, 4 and 5, and compressions 2
and 4, each under photometric 0 and 1 and fill orders 1 and 2. A writer
that refuses a mode is skipped; TIFF's JPEG runs for L, RGB, CMYK and
YCbCr only and its CCITT compressions for mode ``1`` only (libtiff's
encoders refuse the others, and PIL's heap does not survive it).

Needs PIL and the JAX package (no card). ``python3
tools/pil_writer_sweep.py`` prints the tally and each case that is not
equal or None in both; a difference that is not one of the named
deviations (``utils/image.py``'s docstring) is a fault.
"""

import io
import os
import sys
import tempfile
import warnings
from collections import Counter

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

MODES = ["1", "L", "LA", "P", "PA", "RGB", "RGBA", "RGBX", "CMYK", "YCbCr",
         "I", "I;16", "F"]
SIZES = [(1, 1), (5, 7), (37, 29), (64, 64)]
WRITERS = [("PNG", {}), ("BMP", {}), ("TGA", {}),
           ("TGA", {"compression": "tga_rle"}), ("GIF", {}), ("PPM", {}),
           ("WEBP", {"lossless": True}), ("WEBP", {}),
           *[("TIFF", {"compression": c}) for c in (
               "raw", "tiff_lzw", "tiff_adobe_deflate", "packbits", "jpeg",
               "tiff_ccitt", "group3", "group4", "tiff_raw_16")],
           ("JPEG", {}), ("JPEG", {"progressive": True}),
           ("JPEG", {"subsampling": 0}), ("JPEG", {"quality": 95}),
           ("IM", {}), ("SGI", {}), ("PCX", {})]
LIBTIFF_BILEVEL = ("tiff_ccitt", "group3", "group4", "tiff_raw_16")
BILEVEL = [("TIFF", {"compression": "group3",
                     "tiffinfo": {292: o, 262: p, 266: f}})
           for o in (0, 1, 4, 5) for p in (0, 1) for f in (1, 2)] + [
          ("TIFF", {"compression": c, "tiffinfo": {262: p, 266: f}})
          for c in ("tiff_ccitt", "group4") for p in (0, 1) for f in (1, 2)]


def main() -> int:
    from pathtracing_spectrum_tpu.utils import image as jimage
    from pathtracing_spectrum_tpu_torch.utils import image
    from test_torch_readers import pil_image
    warnings.simplefilter("ignore")
    tally, cases = Counter(), []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "x")
        for mode in MODES:
            for w, h in SIZES:
                img = pil_image(mode, w, h, 3)
                for fmt, save in WRITERS + (BILEVEL if mode == "1" else []):
                    comp = save.get("compression")
                    if (comp == "jpeg" and fmt == "TIFF" and mode not in (
                            "L", "RGB", "CMYK", "YCbCr")) or (
                            comp in LIBTIFF_BILEVEL and mode != "1"):
                        continue
                    out = io.BytesIO()
                    try:
                        img.save(out, fmt, **save)
                    except Exception:  # noqa: BLE001 (the writer refuses)
                        continue
                    with open(path, "wb") as f:
                        f.write(out.getvalue())
                    want = jimage.load_rgba(path)
                    case = (mode, f"{w}x{h}", fmt, save)
                    try:
                        got = image.load_rgba(path)
                    except NotImplementedError as e:
                        tally["refused"] += 1
                        cases.append(("refused",) + case + (str(e)[-80:],))
                        continue
                    if (want is None) != (got is None):
                        kind = "none in one"
                    elif want is None:
                        kind = "none in both"
                    elif want.shape != got.shape or not np.array_equal(
                            want.view(np.int32), got.view(np.int32)):
                        kind = "pixels differ"
                    else:
                        kind = "equal"
                    tally[kind] += 1
                    if kind in ("none in one", "pixels differ"):
                        cases.append((kind,) + case)
    print(dict(tally))
    for c in cases:
        print(*c)
    return 0


if __name__ == "__main__":
    sys.exit(main())
