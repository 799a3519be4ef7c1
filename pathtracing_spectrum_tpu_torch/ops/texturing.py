"""Texture tables and nearest sampling (torch).

Port of ``pathtracing_spectrum_tpu/ops/texturing.py``: every texture of a
kind lives in one padded table ``[K, Hmax, Wmax(, C)]`` with a per-texture
(w, h), built on the host in numpy (:func:`build_texture_table`, a copy),
and a hit samples it with one flat gather. The reference's rules hold:
nearest texel at ``(int(W*u), int(H*v))``, clamped to the last texel at
u = 1 or v = 1 (the reference reads out of bounds there), and black for
UVs outside [0, 1] or ``tex_id < 0`` (image.cpp:46-64).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch


def build_texture_table(images: List[np.ndarray], channels: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad variable-size images into one table.

    Args:
      images: list of [H, W, C] (or [H, W] if channels == 0) float32 arrays.
      channels: 4 for RGBA textures, 0 for scalar grids.

    Returns (table [K, Hmax, Wmax(, C)], sizes [K, 2] int32 = (w, h)); with
    no images a zero-length table ``[0, 1, 1(, C)]``.
    """
    shape_tail = (channels,) if channels else ()
    if not images:
        return (np.zeros((0, 1, 1) + shape_tail, np.float32),
                np.zeros((0, 2), np.int32))
    hm = max(im.shape[0] for im in images)
    wm = max(im.shape[1] for im in images)
    table = np.zeros((len(images), hm, wm) + shape_tail, np.float32)
    sizes = np.zeros((len(images), 2), np.int32)
    for i, im in enumerate(images):
        table[i, :im.shape[0], :im.shape[1]] = im
        sizes[i] = (im.shape[1], im.shape[0])
    return table, sizes


def sample_nearest_wh(table: torch.Tensor, tex_id: torch.Tensor,
                      w: torch.Tensor, h: torch.Tensor, u: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """Nearest fetch with the per-ray (w, h) given as float planes (the
    engine reads them from the shading table). ``tex_id`` is [N] int32;
    returns [N, C] (or [N] for a scalar table)."""
    tid = tex_id.clamp_min(0)
    wi = w.to(torch.int32).clamp_min(1)
    hi = h.to(torch.int32).clamp_min(1)
    x = torch.minimum((w * u).to(torch.int32).clamp_min(0), wi - 1)
    y = torch.minimum((h * v).to(torch.int32).clamp_min(0), hi - 1)
    k, hm, wm = table.shape[0], table.shape[1], table.shape[2]
    flat = table.reshape((k * hm * wm,) + tuple(table.shape[3:]))
    vals = flat[((tid * hm + y) * wm + x).long()]
    in_bounds = ((u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
                 & (tex_id >= 0))
    if vals.dim() > in_bounds.dim():
        in_bounds = in_bounds[..., None]
    return torch.where(in_bounds, vals, 0.0)


def sample_nearest(table: torch.Tensor, sizes: torch.Tensor,
                   tex_id: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Nearest fetch with the per-texture sizes looked up from ``sizes``
    [K, 2] (w, h); ``uv`` is [N, 2]."""
    tid = tex_id.clamp_min(0).long()
    wh = sizes[tid].to(torch.float32)
    return sample_nearest_wh(table, tex_id, wh[..., 0], wh[..., 1],
                             uv[..., 0], uv[..., 1])
