"""CIELab to RGBA8 as PIL 12.1's ``convert("RGBA")`` of mode ``LAB`` gives
it, which the TIFF (photometric 8) and PSD (colour mode 9) readers of
``utils/image.py`` run.

PIL converts ``LAB`` through LittleCMS (``Image.convert`` builds
``ImageCms.buildTransform(createProfile("LAB"), createProfile("sRGB"),
"LAB", "RGBA")``: perceptual intent, no flags), not by a formula, and
PIL's wheel bundles lcms 2.17. lcms samples the whole float pipeline into
a 33x33x33 16-bit table and interpolates it; the port copies both halves:

- :func:`table`, built once a process in numpy (no compiler may fuse a
  multiply and an add here): at each grid node ``floor(i * 65535 / 32 +
  0.5)``, its float32 fraction of 65535 as L* (x 100) and a*, b* (x 255
  - 128) in double; CIE Lab to XYZ under D50 (0.9642, 1.0, 0.8249);
  XYZ over lcms's 1 + 32767/32768 as float32; lcms's built-in sRGB
  matrix (white xy (0.3127, 0.3290), the three primaries, ``P diag(P^-1
  W)`` adapted to D50 by Bradford, in doubles, inverted by lcms's own
  cofactors and scaled by 1 + 32767/32768) summed in double and rounded
  to float32; the inverse of lcms's parametric curve 4 (sRGB) in double,
  rounded to float32; ``_cmsQuickSaturateWord(y * 65535)``;
- the interpolation, ``csrc/lab_srgb.cpp`` in the host library:
  lcms's ``TetrahedralInterp16`` over the table in integers, the 8-bit
  input as ``x * 257``, the output as lcms's 16-to-8 rounding.

White (L* 100, a* = b* = 0) comes out (254, 255, 254) and black (1, 0,
1): lcms fixes no white point on this path, and neither does the port.
The fourth byte is the caller's (copied, not fixed): PIL's ``LAB`` pixel
has four bytes, and lcms passes the fourth through as alpha, 255 where
PIL's ``LAB`` unpacker wrote it (TIFF), 0 where its band unpackers left
PIL's zeroed image memory (PSD).

:func:`lab_rgb_plain` is the interpolation in numpy, for the tests and
``tools/cielab_sweep.py``; nothing on the load path runs it.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np

from .. import _build

GRID = 33
# lcms's MAX_ENCODEABLE_XYZ: XYZ's 1.15 fixed-point range
_XYZ_ADJ = 1.0 + 32767.0 / 32768.0
_D50 = (0.9642, 1.0, 0.8249)
_BRADFORD = ((0.8951, 0.2664, -0.1614), (-0.7502, 1.7135, 0.0367),
             (0.0389, -0.0685, 1.0296))
# cmsCreate_sRGBProfile: the white point and the primaries (xy)
_SRGB_WHITE = (0.3127, 0.3290)
_SRGB_PRIMARIES = ((0.64, 0.33), (0.30, 0.60), (0.15, 0.06))
# the sRGB curve, lcms's parametric type 4 (gamma, a, b, c, d)
_SRGB_CURVE = (2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045)


def _inverse(a):
    """lcms's ``_cmsMAT3inverse``: cofactors over the determinant, in its
    order of operations (Python floats are C doubles)."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return (
        (c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
         (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det),
        (c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
         (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det),
        (c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
         (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det))


def _product(a, b):
    """lcms's ``_cmsMAT3per``: ``a @ b``."""
    return tuple(tuple(a[i][0] * b[0][j] + a[i][1] * b[1][j]
                       + a[i][2] * b[2][j] for j in range(3))
                 for i in range(3))


def _apply(a, v):
    """lcms's ``_cmsMAT3eval``: ``a @ v``."""
    return tuple(a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2]
                 for i in range(3))


def _srgb_to_xyz():
    """lcms's sRGB colorant matrix (RGB to XYZ under D50), as
    ``_cmsBuildRGB2XYZtransferMatrix`` builds it for the built-in sRGB
    profile: not rounded to s15Fixed16, as the profile is never
    written out."""
    (xr, yr), (xg, yg), (xb, yb) = _SRGB_PRIMARIES
    xn, yn = _SRGB_WHITE
    prim = ((xr, xg, xb), (yr, yg, yb),
            (1 - xr - yr, 1 - xg - yg, 1 - xb - yb))
    coef = _apply(_inverse(prim), (xn / yn, 1.0, (1.0 - xn - yn) / yn))
    m = ((coef[0] * xr, coef[1] * xg, coef[2] * xb),
         (coef[0] * yr, coef[1] * yg, coef[2] * yb),
         (coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg),
          coef[2] * (1.0 - xb - yb)))
    # _cmsAdaptMatrixToD50: Bradford from the white point (Y 1) to D50
    white = (xn / yn, 1.0, (1 - xn - yn) / yn)
    src, dst = _apply(_BRADFORD, white), _apply(_BRADFORD, _D50)
    cone = ((dst[0] / src[0], 0.0, 0.0), (0.0, dst[1] / src[1], 0.0),
            (0.0, 0.0, dst[2] / src[2]))
    adapt = _product(_inverse(_BRADFORD), _product(cone, _BRADFORD))
    return _product(adapt, m)


def _f32(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32).astype(np.float64)


@functools.lru_cache(maxsize=1)
def table() -> np.ndarray:
    """[33, 33, 33, 3] uint16 (read-only): lcms 2.17's Lab to sRGB
    transform at its grid nodes, indexed (L, a, b), as the module
    docstring says."""
    # the grid nodes' 16-bit values (_cmsQuantizeVal), as lcms's float32
    nodes = np.floor(np.arange(GRID) * 65535.0 / (GRID - 1) + 0.5)
    x = _f32(nodes / 65535.0)
    lx, ax, bx = np.meshgrid(x, x, x, indexing="ij")
    lum, a, b = lx * 100.0, ax * 255.0 - 128.0, bx * 255.0 - 128.0
    fy = (lum + 16.0) / 116.0
    fx = fy + 0.002 * a
    fz = fy - 0.005 * b

    def f_inv(t):                                # cmsLab2XYZ's f_1
        return np.where(t <= 24.0 / 116.0,
                        (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)

    xyz = [_f32(f_inv(t) * w / _XYZ_ADJ) for t, w in zip((fx, fy, fz),
                                                          _D50)]
    inv = _inverse(_srgb_to_xyz())
    g, pa, pb, pc, pd = _SRGB_CURVE
    out = np.empty(lum.shape + (3,), np.uint16)
    for i in range(3):
        row = [v * _XYZ_ADJ for v in inv[i]]
        lin = _f32(xyz[0] * row[0] + xyz[1] * row[1] + xyz[2] * row[2])
        with np.errstate(invalid="ignore"):
            enc = np.where(lin >= pc * pd,
                           (np.power(np.maximum(lin, 0.0), 1.0 / g) - pb)
                           / pa, lin / pc)
        word = _f32(enc) * 65535.0 + 0.5         # _cmsQuickSaturateWord
        out[..., i] = np.floor(np.clip(word, 0.0, 65535.0)).astype(np.uint16)
    out.flags.writeable = False
    return out


def table_digest() -> str:
    """The sha256 of :func:`table`'s little-endian bytes."""
    return hashlib.sha256(table().astype("<u2").tobytes()).hexdigest()


def lab_rgba(lab: np.ndarray, alpha: int) -> np.ndarray:
    """[..., 4] uint8 RGBA of [..., 3] uint8 L*, a*, b* samples (a* and
    b* with 128 as zero, as lcms's ``TYPE_Lab_8`` takes them), alpha
    ``alpha``: the host library's interpolation of :func:`table`."""
    src = np.ascontiguousarray(lab, np.uint8)
    if src.ndim == 0 or src.shape[-1] != 3 or not 0 <= alpha <= 255:
        raise ValueError(f"Lab samples of shape [..., 3] and an 8-bit "
                         f"alpha, not {src.shape} and {alpha}")
    lib = _build.load_host()
    out = np.empty(src.shape[:-1] + (4,), np.uint8)
    n = src.size // 3
    if n:
        lib.pts_lab_srgb(table().ctypes.data, src.ctypes.data, n, alpha,
                         out.ctypes.data)
    return out


def _wrap32(v: np.ndarray) -> np.ndarray:
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def lab_rgb_plain(lab: np.ndarray) -> np.ndarray:
    """[..., 3] uint8 RGB of [..., 3] uint8 Lab: lcms's
    ``TetrahedralInterp16`` of :func:`table` in numpy (the plain version
    of ``csrc/lab_srgb.cpp``)."""
    shape = lab.shape[:-1]
    v = lab.reshape(-1, 3).astype(np.int64) * 257
    d = v * (GRID - 1)
    f = d + (d + 0x7FFF) // 0xFFFF               # _cmsToFixedDomain
    lo, r = f >> 16, f & 0xFFFF
    up = (v != 0xFFFF).astype(np.int64)
    t = table().astype(np.int64)
    rx, ry, rz = r[:, 0], r[:, 1], r[:, 2]

    def node(dx, dy, dz):
        return t[lo[:, 0] + dx * up[:, 0], lo[:, 1] + dy * up[:, 1],
                 lo[:, 2] + dz * up[:, 2]]

    c0 = node(0, 0, 0)
    # lcms's six tetrahedra, in its order and with its ties: the axes
    # walked from the lower node to the upper one
    ge_xy, ge_yz, ge_zx, ge_xz = rx >= ry, ry >= rz, rz >= rx, rx >= rz
    picks = (ge_xy & ge_yz, ge_xy & ~ge_yz & ge_zx, ge_xy & ~ge_yz & ~ge_zx,
             ~ge_xy & ge_xz, ~ge_xy & ~ge_xz & ge_yz,
             ~ge_xy & ~ge_xz & ~ge_yz)
    out = np.zeros_like(c0)
    for pick, path in zip(picks, ("xyz", "zxy", "xzy", "yxz", "yzx", "zyx")):
        at, prev, slope = [0, 0, 0], c0, {}
        for axis in path:
            at["xyz".index(axis)] = 1
            cur = node(*at)
            slope[axis], prev = cur - prev, cur
        rest = _wrap32(slope["x"] * rx[:, None] + slope["y"] * ry[:, None]
                       + slope["z"] * rz[:, None] + 0x8001)
        y = c0 + (_wrap32(rest + (rest >> 16)) >> 16)
        out = np.where(pick[:, None], y, out)
    word = out & 0xFFFF
    return ((word * 65281 + 8388608) >> 24).astype(np.uint8).reshape(
        shape + (3,))
