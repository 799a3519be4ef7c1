"""Bounce-ray reorder: the sort key, the scene frame it quantises in, and
the permutation.

Port of ``pathtracing_spectrum_tpu/reorder.py``. Before each intersection
from the first sorted bounce on, the engine sorts the rays by a key of
(dead bit, direction octant, origin morton cell), so that neighbouring
rays share a direction octant and an origin cell: the threads of a warp
then walk similar paths in K3 and need the same clusters in K4, and dead
rays gather at the end. Any permutation gives the same result (the
kernels select per ray, with the lowest-index tie rule), so the reorder
changes time, never pixels.

The key is bit for bit the JAX package's (``sort_key``, ``scene_bounds``,
``root_bounds``). What differs is how the sort is applied: the TPU sorts in
segments and inverts with a second segmented argsort because sorts and
scatters are slow there (``reorder.py:16-20``); the port takes one global
stable ``torch.argsort`` of the key and a scatter for the inverse.

Left out (ROADMAP Queue 1 item 10): the segment policy, the
``PTS_REORDER_POS_BITS`` knob (the morton width is the constant 4),
``reorder_period``/``reorder_freeze`` and the material-keyed sort.
"""

from __future__ import annotations

import torch

# "auto" reorder only at or above this many triangles (the JAX package's
# REORDER_AUTO_MIN_TRIS).
REORDER_AUTO_MIN_TRIS = 1024

# morton bits per origin axis; 3 * 4 + 3 octant bits + the dead bit fit
# well inside int32
REORDER_POS_BITS = 4

# Size-aware first sorted iteration (the JAX package's reorder_from
# "auto", engine.py:131-172, whose table was measured on a TPU).
REORDER_FROM_TINY_TRIS = 4096      # below: sort the last iteration only
REORDER_FROM_SMALL_TRIS = 32768    # below: skip the h = 1 sort


def reorder_from_policy(n_tris: int, max_depth: int = 3) -> int:
    """The first looped bounce iteration that sorts (iterations run
    h = 1 .. 2*max_depth - 1)."""
    if n_tris < REORDER_FROM_TINY_TRIS:
        return 2 * max_depth - 1
    if n_tris < REORDER_FROM_SMALL_TRIS:
        return 2
    return 1


def root_bounds(cluster_aabbs: torch.Tensor):
    """Scene root AABB (lo [3], hi [3]) over the valid cluster boxes
    (padding clusters carry inverted boxes and are left out)."""
    valid = (cluster_aabbs[:, 0] <= cluster_aabbs[:, 3])[:, None]
    inf = torch.tensor(float("inf"), dtype=cluster_aabbs.dtype,
                       device=cluster_aabbs.device)
    lo = torch.where(valid, cluster_aabbs[:, 0:3], inf).amin(dim=0)
    hi = torch.where(valid, cluster_aabbs[:, 3:6], -inf).amax(dim=0)
    return lo, hi


def scene_bounds(cluster_aabbs: torch.Tensor):
    """(smin [3], 1 / extent [3]) of the scene root box: the frame the
    morton cells quantise in."""
    smin, smax = root_bounds(cluster_aabbs)
    floor = torch.tensor(1e-6, dtype=smin.dtype, device=smin.device)
    return smin, 1.0 / torch.maximum(smax - smin, floor)


def sort_key(ox, oy, oz, dx, dy, dz, alive, smin, inv_ext) -> torch.Tensor:
    """[N] int32 key: dead rays above every live one, then the direction
    octant, then the origin's morton cell in the scene frame.

    Only live rays' keys matter. A dead ray is parked at origin 1e30, and
    the float-to-int32 conversion of an out-of-range value differs between
    torch (undefined, in practice INT_MIN) and XLA (saturating); the final
    ``where(alive, key, dead_bit)`` masks it either way."""
    dead_bit = 1 << (3 * REORDER_POS_BITS + 3)
    cells = 1 << REORDER_POS_BITS

    def q(v, lo, ie):
        return ((v - lo) * ie * cells).to(torch.int32).clamp(0, cells - 1)

    qx = q(ox, smin[0], inv_ext[0])
    qy = q(oy, smin[1], inv_ext[1])
    qz = q(oz, smin[2], inv_ext[2])
    m = torch.zeros_like(qx)
    for b in range(REORDER_POS_BITS):
        m = (m | (((qx >> b) & 1) << (3 * b + 2))
             | (((qy >> b) & 1) << (3 * b + 1))
             | (((qz >> b) & 1) << (3 * b)))
    octant = ((dx < 0).to(torch.int32) * 4 + (dy < 0).to(torch.int32) * 2
              + (dz < 0).to(torch.int32))
    key = (octant << (3 * REORDER_POS_BITS)) | m
    return torch.where(alive, key, torch.full_like(key, dead_bit))


def permutation(key: torch.Tensor):
    """(perm, inv) of a stable ascending sort of ``key``: ``x[perm]`` is
    sorted and ``y[inv]`` undoes it. ``permutation.calls`` counts the
    sorts."""
    perm = torch.argsort(key, stable=True)
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], device=perm.device)
    permutation.calls += 1
    return perm, inv


permutation.calls = 0
