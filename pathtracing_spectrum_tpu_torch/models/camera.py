"""Pinhole camera, reproducing the reference's ray generation (torch).

Port of ``pathtracing_spectrum_tpu/models/camera.py`` (reference
``PathTracer::RenderFrame`` camera setup, pathtracer.cpp:560-571, and the
``SetProjection`` clamps, pathtracer.cpp:343-353): image plane centred at
``pos + dir * focal``, height ``2 * focal * tan(fovy/2)``, rays through the
top-left corner of each pixel, row 0 = image top. The reference has no
sub-pixel jitter; ``camera_rays(key=, jitter=True)`` and the batched
:class:`JitterCam` (regenerated per sample inside
``engine.render_samples``) add it as the JAX package does, drawing the
offsets through the threefry kernel under JAX's keys.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops import rng, rng_cuda


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


class JitterCam(NamedTuple):
    """The camera for per-sample jittered rays (JAX ``models/camera.py::
    JitterCam``), as float32 tensors on one device. ``px``/``py`` are the
    pixel coordinates of each ray slot in the engine's ray order (tile
    order in a session), so the offsets are drawn in that order."""

    px: torch.Tensor        # [N] pixel x in ray-slot order
    py: torch.Tensor        # [N] pixel y
    pos: torch.Tensor       # [3]
    top_left: torch.Tensor  # [3]
    right: torch.Tensor     # [3]
    up: torch.Tensor        # [3]
    dx: torch.Tensor        # [] pixel width on the image plane
    dy: torch.Tensor        # [] pixel height


def jitter_cam_arrays(cam: Camera, width: int, height: int,
                      perm: Optional[np.ndarray] = None,
                      device: "torch.device | str" = DEFAULT_DEVICE
                      ) -> JitterCam:
    """The :class:`JitterCam` of ``cam`` on ``device`` (the card unless
    the caller asks for the CPU). The image plane is set up on the host in
    float32 numpy exactly as the JAX ``jitter_cam_arrays`` does it, so the
    fields are the JAX ones bit for bit; ``perm`` maps ray slots to
    scanline pixels."""
    device = resolve_device(device)
    cam = cam.clamped()
    pos = np.asarray(cam.position, np.float32)
    d = np.asarray(cam.direction, np.float32)
    up = np.asarray(cam.up, np.float32)
    img_center = pos + d * cam.focal
    img_h = 2.0 * cam.focal * math.tan(math.radians(cam.fovy_deg / 2.0))
    img_w = img_h * (float(width) / float(height))
    right = np.cross(up, d)
    right = (right / np.linalg.norm(right)).astype(np.float32)
    top_left = img_center - right * (img_w * 0.5) + up * (img_h * 0.5)
    idx = (np.asarray(perm, np.int64) if perm is not None
           else np.arange(width * height, dtype=np.int64))
    fields = ((idx % width).astype(np.float32),
              (idx // width).astype(np.float32), pos,
              top_left.astype(np.float32), right, up,
              np.float32(img_w / float(width)),
              np.float32(img_h / float(height)))
    return JitterCam(*(torch.tensor(a, dtype=torch.float32, device=device)
                       for a in fields))


def jittered_dirs(jc: JitterCam, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """[N, 3] unit directions through the sub-pixel offsets (u, v) in
    [0, 1) of each ray slot: the jittered form of :func:`camera_rays`'
    pixel-corner rays."""
    xo = (jc.px + u) * jc.dx
    yo = (jc.py + v) * jc.dy
    pix = (jc.top_left[None, :] - jc.up[None, :] * yo[:, None]
           + jc.right[None, :] * xo[:, None])
    return _norm_rows(pix - jc.pos[None, :])


def camera_rays(cam: Camera, width: int, height: int,
                device: "torch.device | str" = DEFAULT_DEVICE,
                key: Optional[rng.Key] = None, jitter: bool = False):
    """Primary rays through the pixel corners, or with ``jitter`` and a
    ``key`` through corners offset by ``uniform(kx, (h, w))`` and
    ``uniform(ky, (h, w))``, ``kx, ky = split(key)`` (the JAX
    ``camera_rays``; drawn by the threefry kernel on a CUDA device).

    Returns (origins [N,3], directions [N,3]) float32 on ``device`` (the
    card unless the caller asks for the CPU), with N = width*height,
    row-major, row 0 = image top.
    """
    device = resolve_device(device)
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
    if jitter and key is not None:
        kx, ky = rng.split(key)
        jj = jj + rng_cuda.uniform(kx, (height, width), device)
        ii = ii + rng_cuda.uniform(ky, (height, width), device)
    pixel = (top_left[None, None, :]
             - up[None, None, :] * (ii * dy)[..., None]
             + right[None, None, :] * (jj * dx)[..., None])
    dirs = _norm_rows(pixel - pos[None, None, :])
    n = width * height
    origins = pos.expand(n, 3).contiguous()
    return origins, dirs.reshape(n, 3)
