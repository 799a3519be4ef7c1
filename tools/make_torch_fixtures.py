#!/usr/bin/env python3
"""Write the texture fixtures of the PyTorch port into ``tests/torch_data/``.

The machine with the card has no PIL, so ``chip_smoke.py`` holds the
port's decodes there by digest: this script makes each fixture with PIL
(or by hand, for the PNG flavours PIL does not write) and records, in
``tests/torch_data/digests.json``, the sha256 of PIL's ``convert("RGBA")``
bytes of each. For the 16-bit grey PNG it records the high-byte image
instead: the port's one named deviation from PIL, which clips that mode
at 255. ``tests/test_torch_formats.py`` checks the digests against PIL's
decode on every run.

Fixtures (all content procedural, from fixed seeds):

- ``roughness_2048_prog420.jpg``: 2048x2048 progressive 4:2:0 JPEG,
  quality 90, smooth ramps and waves (the textured 1080p session's
  roughness map);
- ``normal_1024_444.jpg``: 1024x1024 baseline 4:4:4 JPEG, quality 90, a
  field of bumps encoded as tangent-space normals (its normal map);
- ``small.bmp`` (24-bit), ``small.tga`` (run-length RGBA), ``small.ppm``
  (P6), ``grey16.png`` (16-bit grey) and ``adam7.png`` (8-bit RGB,
  Adam7-interlaced), 37x29 each.

Run from the repository root: ``python3 tools/make_torch_fixtures.py``.
"""

import hashlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "tests", "torch_data")
SMALL = (29, 37)     # (H, W), odd on purpose


def _images_module():
    spec = importlib.util.spec_from_file_location(
        "torch_images", os.path.join(HERE, "tests", "torch_images.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def roughness_map(n: int = 2048) -> np.ndarray:
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / n
    r = 0.5 + 0.5 * np.sin(6.2831853 * (3 * xx + 2 * yy)) * np.cos(
        6.2831853 * 4 * yy)
    g = 0.5 + 0.5 * np.sin(6.2831853 * (5 * xx * yy + xx))
    b = 0.5 + 0.5 * np.cos(6.2831853 * (2 * xx - 3 * yy))
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def normal_map(n: int = 1024, bumps: int = 8) -> np.ndarray:
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) * (bumps / n)
    # height sin(2 pi x) sin(2 pi y): tangent-space normal (-dh/dx, -dh/dy, 1)
    dx = 0.6 * np.cos(6.2831853 * xx) * np.sin(6.2831853 * yy)
    dy = 0.6 * np.sin(6.2831853 * xx) * np.cos(6.2831853 * yy)
    nrm = np.stack([-dx, -dy, np.ones_like(dx)], -1)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    return ((nrm * 0.5 + 0.5) * 255).round().astype(np.uint8)


def fixtures():
    """{name: (file bytes, RGBA8 the port must decode, how it was got)}."""
    ti = _images_module()
    rng = np.random.default_rng(9)
    h, w = SMALL
    small = ti.smooth_rgb(9, w, h)
    alpha = rng.integers(0, 256, (h, w, 1), np.uint8)
    alpha[:, :w // 2] = 255                       # runs for the RLE

    def pil_file(img, fmt, **save):
        out = io.BytesIO()
        img.save(out, fmt, **save)
        return out.getvalue()

    files = {
        "roughness_2048_prog420.jpg": ti.jpeg_bytes(
            roughness_map(), quality=90, progressive=True, subsampling=2),
        "normal_1024_444.jpg": ti.jpeg_bytes(
            normal_map(), quality=90, subsampling=0),
        "small.bmp": pil_file(Image.fromarray(small), "BMP"),
        "small.tga": pil_file(Image.fromarray(np.concatenate(
            [small, alpha], -1), "RGBA"), "TGA", compression="tga_rle"),
        "small.ppm": pil_file(Image.fromarray(small), "PPM"),
        "adam7.png": ti.png_bytes(small, 2, 8, interlace=1),
    }
    out = {}
    for name, data in files.items():
        out[name] = (data, ti.pil_rgba8(data), 'PIL convert("RGBA")')
    grey = rng.integers(0, 1 << 16, (h, w, 1))
    high = np.full((h, w, 4), 255, np.uint8)
    high[..., :3] = (grey >> 8).astype(np.uint8)
    out["grey16.png"] = (ti.png_bytes(grey, 0, 16), high,
                         "the high byte of each 16-bit sample (the port's "
                         "named deviation: PIL clips mode I;16 at 255)")
    return out


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    digests = {}
    for name, (data, rgba, how) in fixtures().items():
        with open(os.path.join(OUT, name), "wb") as f:
            f.write(data)
        digests[name] = {"shape": list(rgba.shape), "rgba_sha256":
                         hashlib.sha256(rgba.tobytes()).hexdigest(),
                         "of": how}
        print(f"{name}: {len(data)} bytes, {rgba.shape[1]}x{rgba.shape[0]}")
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
