"""PIL 12.1's resampling of 8-bit L and RGB images, which the ICO and ICNS
writers of ``utils/image.py`` run: the host library's copy of
``ImagingResample`` (``csrc/resample.cpp``) under the LANCZOS and BICUBIC
filters, and ``Image.thumbnail``'s rule for the size that keeps the
aspect ratio. Each output pixel sums up to thousands of weighted samples
(a 3840x2160 image thumbnailed to 16x9 weighs about 1,440 columns for
each), so host C++, with no Python fallback: when the host library
cannot be built, the call raises with the compiler's output.
"""

from __future__ import annotations

import math

import numpy as np

from .. import _build

# the filter numbers of csrc/resample.cpp
LANCZOS, BICUBIC = 1, 2


def resize(img: np.ndarray, size, resample: int = BICUBIC) -> np.ndarray:
    """``Image.resize(size, resample)`` of uint8 ``img`` ([H, W] L or
    [H, W, 3] RGB; ``size`` is (width, height)): a copy where the size is
    the image's own, else PIL's two passes, byte for byte."""
    width, height = (int(v) for v in size)
    h, w = img.shape[:2]
    if (width, height) == (w, h):
        return img.copy()
    if width <= 0 or height <= 0:
        raise ValueError("height and width must be > 0")
    lib = _build.load_host()
    src = np.ascontiguousarray(img, np.uint8)
    out = np.empty((height, width) + img.shape[2:], np.uint8)
    if lib.pts_resample(src.ctypes.data, w, h, 1 if img.ndim == 2 else 3,
                        width, height, resample, out.ctypes.data):
        raise ValueError(f"cannot resample a {img.shape} image")
    return out


def thumbnail_size(width: int, height: int, box) -> "tuple[int, int] | None":
    """The size ``Image.thumbnail(box)`` gives a ``width`` x ``height``
    image (``preserve_aspect_ratio``: the side the box binds, the other
    rounded down or up, whichever keeps the aspect ratio closer, at least
    1), or None where the image fits the box and is left as it is."""
    x, y = (math.floor(v) for v in box)
    if x >= width and y >= height:
        return None

    def round_aspect(number: float, key) -> int:
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = width / height
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda n: abs(aspect - n / y))
    else:
        y = round_aspect(x / aspect,
                         key=lambda n: 0 if n == 0 else abs(aspect - x / n))
    return x, y


def thumbnail(img: np.ndarray, box, resample: int = BICUBIC) -> np.ndarray:
    """``Image.thumbnail(box, resample, reducing_gap=None)`` of a copy of
    ``img``: resampled straight to :func:`thumbnail_size` (no reducing
    first), or the image itself where it fits the box."""
    h, w = img.shape[:2]
    size = thumbnail_size(w, h, box)
    return img.copy() if size is None else resize(img, size, resample)
