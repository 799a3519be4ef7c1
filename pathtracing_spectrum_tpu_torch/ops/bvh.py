"""Flat skip-link BVH: the host build and K3's plain version.

Port of ``pathtracing_spectrum_tpu/ops/bvh.py``. The tree is stored in DFS
preorder with skip links: node ``i``'s children start at ``i + 1``;
``skip[i]`` is the next node when ``i`` is missed or finished; a leaf
(``count > 0``) covers the triangle rows ``first .. first + count - 1`` of
the reordered table. Traversal is a forward walk with one int32 of state
per ray and no stack.

:func:`build_bvh` runs the binned-SAH builder of ``csrc/bvh_build.cpp`` (a
copy of the JAX package's native builder, built with the host compiler at
first use). There is no fallback: the JAX package falls back to a Python
median split when its native library is missing; the port raises instead,
so a BVH-ordered scene is always the SAH tree.

:func:`intersect_bvh_ref` is the plain version of the CUDA kernel
``csrc/intersect_bvh.cu`` (wrapper: ``ops/intersect_hier_cuda.py``), and
the port's CPU route for the ``"bvh"``/``"hier"`` backends.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import _build
from ..constants import BIG
from .intersect import box_hits, ray_slab_setup, tri_hits

# (ray, triangle) pairs per step of the plain version's leaf test: bounds
# its temporaries when leaves are large (the passthrough BVH has one leaf
# of all T triangles).
_REF_PAIRS = 1 << 22


@dataclasses.dataclass
class FlatBVH:
    node_min: np.ndarray    # [NN, 3] float32
    node_max: np.ndarray    # [NN, 3] float32
    node_skip: np.ndarray   # [NN] int32
    node_first: np.ndarray  # [NN] int32 (valid for leaves)
    node_count: np.ndarray  # [NN] int32 (0 = internal)
    tri_order: np.ndarray   # [T] int64 permutation applied to the SoA


def triangle_bounds(soa):
    """Per-triangle (min, max) corners, [T, 3] float32 each, computed in
    float64 from v1, v1 + e1, v1 + e2 as the JAX package computes them."""
    v1 = soa.v1.astype(np.float64)
    v2 = v1 + soa.e1.astype(np.float64)
    v3 = v1 + soa.e2.astype(np.float64)
    return (np.minimum(np.minimum(v1, v2), v3).astype(np.float32),
            np.maximum(np.maximum(v1, v2), v3).astype(np.float32))


def build_bvh(soa, leaf_size: int = 4) -> FlatBVH:
    """Binned-SAH flat BVH over a TriangleSoA (host, native builder).

    Raises when the builder cannot be built or fails."""
    lib = _build.load_host()
    tri_min, tri_max = (np.ascontiguousarray(a)
                        for a in triangle_bounds(soa))
    t = tri_min.shape[0]
    handle = lib.pts_bvh_build(tri_min.ctypes.data, tri_max.ctypes.data,
                               t, leaf_size)
    if not handle:
        raise RuntimeError("BVH build failed")
    try:
        nn = lib.pts_bvh_node_count(handle)
        flat = FlatBVH(node_min=np.zeros((nn, 3), np.float32),
                       node_max=np.zeros((nn, 3), np.float32),
                       node_skip=np.zeros((nn,), np.int32),
                       node_first=np.zeros((nn,), np.int32),
                       node_count=np.zeros((nn,), np.int32),
                       tri_order=np.zeros((t,), np.int64))
        lib.pts_bvh_export(handle, *(ctypes.c_void_p(a.ctypes.data) for a in (
            flat.node_min, flat.node_max, flat.node_skip, flat.node_first,
            flat.node_count, flat.tri_order)))
    finally:
        lib.pts_bvh_free(handle)
    return flat


def intersect_bvh_ref(rox, roy, roz, rdx, rdy, rdz, tri16, node_min,
                      node_max, node_skip, node_first, node_count,
                      stats: Optional[dict] = None):
    """Closest hit through the flat BVH (plain torch), K3's function.

    The lockstep skip-link walk of the JAX package's ``intersect_bvh``
    (``ops/bvh.py:174-232``), with the kernel's box test: every ray still
    walking takes one step per round, the finished ones drop out. Two
    deviations from the JAX walk, both the kernel's: the leaf test is the
    K-vector predicate of ``ops/intersect.py`` (:func:`tri_hits`, bitwise
    comparable with ``intersect_dense_ref``) and not the cross-product form
    of ``_leaf_hits``; and a box is culled when its entry lies beyond the
    running best t (:func:`box_hits`), where the JAX walk tests the box
    alone. A leaf's rows are tested in ascending index and merged with a
    strict ``<``; leaves come in ascending order, so the lowest index wins
    a tie. Parked rays (rd = 0 on all axes) do not walk.

    Args:
      rox..rdz: [N] float32 ray planes.
      tri16: [T, 16] float32 packed table in BVH order.
      node_min, node_max: [NN, 3] float32; node_skip, node_first,
        node_count: [NN] int32 (``SceneData.bvh_node_*``).
      stats: optional dict; its ``"boxes"`` and ``"tris"`` entries are
        increased by the box tests and the triangle tests the walk makes
        (the data-dependent work a bound on K3 is counted from).

    Returns (hit [N] bool, t [N] f32, idx [N] int32, s2 [N] f32, s3 [N] f32),
    t = BIG, idx = 0, s2 = s3 = 0 on a miss.
    """
    n = rox.shape[0]
    dev = rox.device
    n_nodes = node_min.shape[0]
    o = (rox, roy, roz)
    d = (rdx, rdy, rdz)
    inv, zero = ray_slab_setup(rdx, rdy, rdz)
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_i = torch.zeros(n, dtype=torch.int32, device=dev)
    best_s2 = torch.zeros(n, dtype=torch.float32, device=dev)
    best_s3 = torch.zeros(n, dtype=torch.float32, device=dev)
    skip = node_skip.long()
    first = node_first.long()
    count = node_count.long()

    node = torch.zeros(n, dtype=torch.long, device=dev)
    parked = zero[0] & zero[1] & zero[2]
    active = torch.nonzero(~parked)[:, 0]
    boxes = tris = 0
    while active.numel():
        boxes += active.numel()
        nd = node[active]
        lo, hi = node_min[nd], node_max[nd]
        hit = box_hits([p[active] for p in o], [p[active] for p in inv],
                       [p[active] for p in zero],
                       [lo[:, a] for a in range(3)],
                       [hi[:, a] for a in range(3)], best_t[active])
        cnt = count[nd]
        leaf = hit & (cnt > 0)
        if leaf.any():
            _leaf_test(o, d, tri16, active[leaf], first[nd[leaf]],
                       cnt[leaf], best_t, best_i, best_s2, best_s3)
            if stats is not None:
                tris += int(cnt[leaf].sum())
        nxt = torch.where(hit & (cnt == 0), nd + 1, skip[nd])
        node[active] = nxt
        active = active[nxt < n_nodes]
    if stats is not None:
        stats["boxes"] = stats.get("boxes", 0) + boxes
        stats["tris"] = stats.get("tris", 0) + tris
    return best_t < BIG, best_t, best_i, best_s2, best_s3


def _leaf_test(o, d, tri16, rays, firsts, counts, best_t, best_i, best_s2,
               best_s3) -> None:
    """Test each ray of ``rays`` against its leaf's rows, in ascending
    index, and merge into the running best in place (strict ``<``). Rows
    go in steps of at most ``_REF_PAIRS // len(rays)`` per ray; each step
    keeps its first minimum, so the steps together keep the lowest index."""
    dev = rays.device
    step = max(1, _REF_PAIRS // rays.numel())
    for k0 in range(0, int(counts.max()), step):
        sel = counts > k0
        ray_ids = rays[sel]
        c = (counts[sel] - k0).clamp(max=step)
        starts = torch.cumsum(c, 0) - c
        pair_ray = torch.repeat_interleave(ray_ids, c)
        offs = (torch.arange(int(c.sum()), device=dev)
                - torch.repeat_interleave(starts, c))
        pair_tri = torch.repeat_interleave(firsts[sel] + k0, c) + offs
        rows = tri16[pair_tri]
        valid, t, s2, s3 = tri_hits(*(p[pair_ray] for p in o),
                                    *(p[pair_ray] for p in d),
                                    [rows[:, j] for j in range(16)])
        tt = torch.where(valid, t, BIG)
        local_t = torch.full_like(best_t, BIG).scatter_reduce(
            0, pair_ray, tt, "amin")
        at_min = tt == local_t[pair_ray]
        local_i = torch.full(best_t.shape, tri16.shape[0], dtype=torch.long,
                             device=dev).scatter_reduce(
            0, pair_ray, torch.where(at_min, pair_tri, tri16.shape[0]),
            "amin")
        win = at_min & (pair_tri == local_i[pair_ray])
        better = local_t[pair_ray[win]] < best_t[pair_ray[win]]
        ids = pair_ray[win][better]
        best_t[ids] = tt[win][better]
        best_i[ids] = pair_tri[win][better].to(torch.int32)
        best_s2[ids] = s2[win][better]
        best_s3[ids] = s3[win][better]
