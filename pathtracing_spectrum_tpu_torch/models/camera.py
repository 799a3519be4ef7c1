"""Pinhole camera, reproducing the reference's ray generation (torch).

Port of ``pathtracing_spectrum_tpu/models/camera.py`` (reference
``PathTracer::RenderFrame`` camera setup, pathtracer.cpp:560-571, and the
``SetProjection`` clamps, pathtracer.cpp:343-353): image plane centred at
``pos + dir * focal``, height ``2 * focal * tan(fovy/2)``, rays through the
top-left corner of each pixel (no jitter), row 0 = image top.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    direction: Tuple[float, float, float] = (0.0, 0.0, 1.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    focal: float = 0.1
    fovy_deg: float = 90.0

    def clamped(self) -> "Camera":
        """SetProjection clamps (pathtracer.cpp:343-353)."""
        f = self.focal if self.focal > 0.0 else 0.1
        fovy = self.fovy_deg
        if fovy <= 0.0:
            fovy = 0.1
        elif fovy >= 180.0:
            fovy = 179.5
        d = np.asarray(self.direction, np.float64)
        u = np.asarray(self.up, np.float64)
        d = d / np.linalg.norm(d)
        u = u / np.linalg.norm(u)
        return Camera(tuple(self.position), tuple(d), tuple(u), f, fovy)


def tile_order(width: int, height: int, tile: int = 32):
    """Permutation putting pixels in 32x32 tile-major order, and its inverse:
    ``flat_tiled = flat[perm]`` and ``flat = flat_tiled[inv_perm]``."""
    idx = np.arange(width * height, dtype=np.int64)
    y, x = idx // width, idx % width
    ty, tx = y // tile, x // tile
    key = (((ty * ((width + tile - 1) // tile) + tx) << 20)
           + (y % tile) * tile + (x % tile))
    perm = np.argsort(key, kind="stable").astype(np.int32)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int32)
    return perm, inv


def _norm_rows(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                          + v[..., 2] * v[..., 2])[..., None]


def camera_rays(cam: Camera, width: int, height: int,
                device: "torch.device | str" = "cpu"):
    """Primary rays through the pixel corners.

    Returns (origins [N,3], directions [N,3]) float32 on ``device``, with
    N = width*height, row-major, row 0 = image top.
    """
    cam = cam.clamped()
    f32 = dict(dtype=torch.float32, device=device)
    pos = torch.tensor(cam.position, **f32)
    d = torch.tensor(cam.direction, **f32)
    up = torch.tensor(cam.up, **f32)

    img_center = pos + d * cam.focal
    img_h = 2.0 * cam.focal * math.tan(math.radians(cam.fovy_deg / 2.0))
    img_w = img_h * (float(width) / float(height))
    dx = img_w / float(width)
    dy = img_h / float(height)
    right = _norm_rows(torch.linalg.cross(up, d))

    top_left = img_center - right * (img_w * 0.5) + up * (img_h * 0.5)

    ii, jj = torch.meshgrid(torch.arange(height, **f32),
                            torch.arange(width, **f32), indexing="ij")
    pixel = (top_left[None, None, :]
             - up[None, None, :] * (ii * dy)[..., None]
             + right[None, None, :] * (jj * dx)[..., None])
    dirs = _norm_rows(pixel - pos[None, None, :])
    n = width * height
    origins = pos.expand(n, 3).contiguous()
    return origins, dirs.reshape(n, 3)
