"""K4: the cluster-culled closest hit, dispatched by device.

Wrapper of the CUDA kernel ``csrc/intersect_cluster.cu``, which replaces
the TPU kernel ``pathtracing_spectrum_tpu/ops/intersect_pallas.py::
_cluster_kernel`` (with ``_cluster_group``). For CUDA tensors
:func:`intersect_cluster` launches the kernel (or raises); for CPU tensors
it runs the plain version :func:`intersect_cluster_ref`.

The kernel culls by a box over each 8 consecutive clusters before the
clusters' own boxes, as the TPU kernel does; :func:`pack_clusters` builds
those group boxes once per scene (``engine.make_intersector`` holds them).
:func:`cluster_model` is the kernel's control flow for one warp of 32 rays
in numpy float32 (group and cluster votes, the nearest-first order, the
inclusive re-test, the tie rule, the two ways of sweeping a cluster's
rows, the windows of a full list), so the CPU tests reach what the card
runs, and return its counts too.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..constants import BIG
from .intersect import (CULL_MARGIN, box_hits, intersect_dense_ref,
                        ray_slab_setup)
from .intersect_cuda import check_rays, check_table, hit_outputs, on_cpu

__all__ = ["CLUSTER", "GROUP", "LIST_CAPACITY", "PackedClusters",
           "group_boxes", "pack_clusters", "intersect_cluster",
           "intersect_cluster_ref", "cluster_model", "cluster_model_batch"]

# triangle rows per cluster AABB (the JAX package's intersect_pallas.CLUSTER)
CLUSTER = 128
# clusters per group box (the JAX package's intersect_pallas._KC)
GROUP = 8
# entries of a warp's cluster list (csrc/intersect_cluster.cu, kListMax)
LIST_CAPACITY = 512
WARP = 32
# the JAX package's padding cluster: an inverted box
_NEVER = (1.0, 1.0, 1.0, -1.0, -1.0, -1.0, 0.0, 0.0)


class PackedClusters(NamedTuple):
    """What K4 culls with, built once per scene by :func:`pack_clusters`."""
    aabbs: torch.Tensor    # [C, 8] float32 cluster boxes (a fresh copy)
    groups: torch.Tensor   # [ceil(C / 8), 8] float32 group boxes


def group_boxes(cluster_aabbs: torch.Tensor) -> torch.Tensor:
    """Box over each run of :data:`GROUP` cluster boxes: the JAX
    expression of ``intersect_clustered_pallas_soa``
    (``intersect_pallas.py:392-403``). The last group is padded with
    inverted boxes; an inverted box is left out of its group's union
    through the min/max identities, and a group of only inverted boxes
    gets an inverted box. Returns [ceil(C / 8), 8] float32."""
    c = cluster_aabbs.shape[0]
    n_groups = -(-c // GROUP)
    boxes = cluster_aabbs
    if n_groups * GROUP > c:
        never = torch.tensor(_NEVER, dtype=boxes.dtype, device=boxes.device)
        boxes = torch.cat([boxes, never.expand(n_groups * GROUP - c, 8)])
    grouped = boxes.reshape(n_groups, GROUP, 8)
    lo, hi = grouped[:, :, 0:3], grouped[:, :, 3:6]
    ok = lo <= hi
    gmin = torch.where(ok, lo, torch.inf).amin(dim=1)
    gmax = torch.where(ok, hi, -torch.inf).amax(dim=1)
    degenerate = ~torch.isfinite(gmin[:, 0:1])
    gmin = torch.where(degenerate, 1.0, gmin)
    gmax = torch.where(degenerate, -1.0, gmax)
    return torch.cat([gmin, gmax, torch.zeros_like(gmin[:, :2])], dim=1)


def pack_clusters(cluster_aabbs: torch.Tensor) -> PackedClusters:
    """A scene's ``cluster_aabbs`` for K4: a fresh contiguous copy (16-byte
    aligned, for the kernel's float4 loads) and its group boxes, on the
    table's device."""
    return PackedClusters(
        cluster_aabbs.clone(memory_format=torch.contiguous_format),
        group_boxes(cluster_aabbs).contiguous())


def intersect_cluster_ref(rox, roy, roz, rdx, rdy, rdz, tri16,
                          cluster_aabbs):
    """Closest hit over the BVH-ordered [T, 16] table, swept cluster by
    cluster (plain torch), K4's function.

    Clusters go in ascending order. For each: the rays whose box test
    (:func:`box_hits`, against their running best t) passes are swept
    over the cluster's rows with the dense plain version, and merged with
    a strict ``<``. Parked rays (rd = 0 on all axes) need no cluster.

    Args:
      rox..rdz: [N] float32 ray planes.
      tri16: [T, 16] float32 packed table.
      cluster_aabbs: [ceil(T / 128), 8] float32 (min3, max3, pad2).

    Returns (hit [N] bool, t [N] f32, idx [N] int32, s2 [N] f32, s3 [N] f32).
    """
    n = rox.shape[0]
    dev = rox.device
    t_count = tri16.shape[0]
    planes = (rox, roy, roz, rdx, rdy, rdz)
    inv, zero = ray_slab_setup(rdx, rdy, rdz)
    live = ~(zero[0] & zero[1] & zero[2])
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_i = torch.zeros(n, dtype=torch.int32, device=dev)
    best_s2 = torch.zeros(n, dtype=torch.float32, device=dev)
    best_s3 = torch.zeros(n, dtype=torch.float32, device=dev)
    for c in range(cluster_aabbs.shape[0]):
        base = c * CLUSTER
        if base >= t_count:
            break
        box = cluster_aabbs[c]
        need = live & box_hits(planes[:3], inv, zero, box[0:3], box[3:6],
                               best_t)
        ids = torch.nonzero(need)[:, 0]
        if not ids.numel():
            continue
        _, t, i, s2, s3 = intersect_dense_ref(
            *(p[ids] for p in planes), tri16[base:base + CLUSTER])
        better = t < best_t[ids]
        up = ids[better]
        best_t[up] = t[better]
        best_i[up] = i[better] + base
        best_s2[up] = s2[better]
        best_s3[up] = s3[better]
    return best_t < BIG, best_t, best_i, best_s2, best_s3


def intersect_cluster(rox, roy, roz, rdx, rdy, rdz, tri16, clusters,
                      counts: Optional[torch.Tensor] = None):
    """Closest hit of N rays over the BVH-ordered [T, 16] table with
    per-group and per-cluster box culling.

    ``clusters`` is a :class:`PackedClusters` (:func:`pack_clusters`, once
    per scene) or a scene's raw ``cluster_aabbs`` [ceil(T / 128), 8], which
    is then packed on this call. Returns (hit [N] bool, t [N] f32, idx [N]
    int32, s2 [N] f32, s3 [N] f32), t = BIG and idx = 0 on a miss: K1's
    result on the same table. With ``counts`` (a [3, N] int32 tensor on
    the card) the kernel also writes each ray's box tests, its warp's
    row-test steps and the clusters its warp swept into it.
    ``intersect_cluster.launches`` counts the kernel launches.
    """
    planes = (rox, roy, roz, rdx, rdy, rdz)
    packed = isinstance(clusters, PackedClusters)
    aabbs = clusters.aabbs if packed else clusters
    if on_cpu(*planes, tri16, aabbs):
        if counts is not None:
            raise ValueError("intersect_cluster: counts come from the "
                             "kernel; on the CPU use cluster_model_batch")
        return intersect_cluster_ref(*planes, tri16, aabbs)
    name = "intersect_cluster"
    n, dev = check_rays(name, planes)
    check_table(name, "tri16", tri16, dev, (None, 16), align16=True)
    c_rows = max(-(-tri16.shape[0] // CLUSTER), 1)
    check_table(name, "cluster_aabbs", aabbs, dev, (c_rows, 8),
                align16=packed)
    if not packed:
        clusters = pack_clusters(aabbs)
    check_table(name, "group boxes", clusters.groups, dev,
                (-(-c_rows // GROUP), 8), align16=True)
    if counts is not None:
        check_table(name, "counts", counts, dev, (3, n), dtype=torch.int32)
    lib = _build.load()
    out = hit_outputs(n, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pts_intersect_cluster(
            *(p.data_ptr() for p in planes), tri16.data_ptr(),
            clusters.aabbs.data_ptr(), clusters.groups.data_ptr(), n,
            tri16.shape[0], clusters.groups.shape[0],
            None if counts is None else counts.data_ptr(),
            *(x.data_ptr() for x in out), stream)
    _build.check(err, name)
    intersect_cluster.launches += 1
    return out


intersect_cluster.launches = 0


# ---- the kernel's control flow for one warp, in numpy float32 --------------

_F32 = np.float32
_ONE_PLUS_MARGIN = _F32(1.0 + CULL_MARGIN)
_MARGIN = _F32(CULL_MARGIN)
_INF = _F32(np.inf)
_BIG = _F32(BIG)


def _relax(t):
    return t * _ONE_PLUS_MARGIN + _MARGIN


def _dot3(ax, ay, az, bx, by, bz):
    return (ax * bx + ay * by) + az * bz


def _ordered(near):
    """csrc/intersect_cluster.cu::ordered: float32 bits whose unsigned
    order is the float order."""
    b = np.asarray(near, _F32).view(np.uint32)
    return np.where(b & np.uint32(0x80000000), ~b, b | np.uint32(0x80000000))


def _box_enter(o, inv, zero, box, best_t):
    """tri_hit.cuh::box_enter for each lane: (entered, entry distance)."""
    near = far = None
    for a in range(3):
        lo, hi = box[a], box[3 + a]
        t0 = (lo - o[a]) * inv[a]
        t1 = (hi - o[a]) * inv[a]
        lt = t0 < t1
        n_a, f_a = np.where(lt, t0, t1), np.where(lt, t1, t0)
        inside = (o[a] >= lo) & (o[a] <= hi)
        n_a = np.where(zero[a], np.where(inside, -_INF, _INF), n_a)
        f_a = np.where(zero[a], np.where(inside, _INF, -_INF), f_a)
        near = n_a if near is None else np.where(near > n_a, near, n_a)
        far = f_a if far is None else np.where(far < f_a, far, f_a)
    far_r = _relax(far)
    return (near <= far_r) & (far_r >= 0) & (near <= _relax(best_t)), near


def _row_tests(o, d, rows):
    """tri_hit.cuh::tri_hit of every lane against every row: (valid, t,
    s2, s3), each [lanes, rows]."""
    o = [v[:, None] for v in o]
    d = [v[:, None] for v in d]
    r = [rows[None, :, k] for k in range(16)]
    denom = _dot3(d[0], d[1], d[2], r[0], r[1], r[2])
    ro_n = _dot3(o[0], o[1], o[2], r[0], r[1], r[2])
    safe = np.where(denom == 0, _F32(1.0), denom)
    t = (r[12] - ro_n) / safe
    p = [o[k] + t * d[k] for k in range(3)]
    s1 = _dot3(*p, r[3], r[4], r[5]) - r[13]
    s2 = _dot3(*p, r[6], r[7], r[8]) - r[14]
    s3 = _dot3(*p, r[9], r[10], r[11]) - r[15]
    valid = (denom != 0) & (t >= 0) & (s1 >= 0) & (s2 >= 0) & (s3 >= 0)
    return valid, t, s2, s3


def cluster_model(rays: np.ndarray, tri16: np.ndarray, aabbs: np.ndarray,
                  groups: np.ndarray):
    """K4 for one warp (``csrc/intersect_cluster.cu``, step for step), in
    numpy float32.

    ``rays``: [L <= 32, 6] float32 (ox, oy, oz, dx, dy, dz), the warp's
    lanes; ``tri16``: [T, 16]; ``aabbs``/``groups``: a
    :class:`PackedClusters`' tables. Returns (best t [L], best idx [L],
    s2 [L], s3 [L], box tests [L], the warp's row-test steps, clusters the
    warp swept).
    """
    lanes = rays.shape[0]
    o = [rays[:, k].astype(_F32) for k in range(3)]
    d = [rays[:, 3 + k].astype(_F32) for k in range(3)]
    zero = [v == 0 for v in d]
    live = ~(zero[0] & zero[1] & zero[2])
    inv = [_F32(1.0) / np.where(z, _F32(1.0), v) for z, v in zip(zero, d)]
    t_count = tri16.shape[0]
    n_clusters = -(-t_count // CLUSTER)
    best_t = np.full(lanes, _BIG, _F32)
    best_i = np.zeros(lanes, np.int64)
    best_s2 = np.zeros(lanes, _F32)
    best_s3 = np.zeros(lanes, _F32)
    boxes = np.zeros(lanes, np.int64)
    swept = [0, 0]                       # rows, clusters
    lane = np.arange(lanes)

    def enter(box):
        hit, near = _box_enter(o, inv, zero, box, best_t)
        boxes[live] += 1
        return hit & live, near

    def sweep(entries):
        for key in sorted(entries):
            c = key & 0xFFFFFFFF
            need, _ = enter(aabbs[c])
            if not need.any():
                continue
            base = c * CLUSTER
            rows = tri16[base:base + CLUSTER]
            valid, t, s2, s3 = _row_tests(o, d, rows)
            # the kernel tests the rows side by side, a ray at a time, when
            # that takes fewer warp steps; either way the same rows win
            steps, k = -(-rows.shape[0] // WARP), int(need.sum())
            side = k * (steps + 1) <= rows.shape[0]
            tt = np.where(valid, t, _INF)
            j = tt.argmin(axis=1)            # the lowest row of the least t
            m = tt[lane, j]
            win = need & ((m < best_t) | ((m == best_t) & (base + j < best_i)))
            best_t[win] = m[win]
            best_i[win] = base + j[win]
            best_s2[win] = s2[lane, j][win]
            best_s3[win] = s3[lane, j][win]
            swept[0] += k * steps if side else rows.shape[0]
            swept[1] += 1

    entries = []
    with np.errstate(all="ignore"):
        for g in range(groups.shape[0]):
            if not enter(groups[g])[0].any():
                continue
            if len(entries) + GROUP > LIST_CAPACITY:     # a full window
                sweep(entries)
                entries = []
            for c in range(g * GROUP, min((g + 1) * GROUP, n_clusters)):
                hit, near = enter(aabbs[c])
                if hit.any():
                    entries.append(int(_ordered(near[hit]).min()) << 32 | c)
        sweep(entries)
    return best_t, best_i, best_s2, best_s3, boxes, swept[0], swept[1]


def cluster_model_batch(planes, tri16: torch.Tensor, clusters):
    """:func:`cluster_model` over CPU ray planes, warp by warp (rays 32w
    to 32w + 31): (hit, t, idx, s2, s3) as the kernel returns them, and the
    [3, N] int32 counts of its counting build. ``clusters``: a
    :class:`PackedClusters` or a raw ``cluster_aabbs``."""
    if not isinstance(clusters, PackedClusters):
        clusters = pack_clusters(clusters)
    rays = np.stack([p.numpy() for p in planes], axis=1).astype(_F32)
    table = tri16.numpy()
    aabbs, groups = clusters.aabbs.numpy(), clusters.groups.numpy()
    n = rays.shape[0]
    t = np.empty(n, _F32)
    idx = np.empty(n, np.int32)
    s2 = np.empty(n, _F32)
    s3 = np.empty(n, _F32)
    counts = np.empty((3, n), np.int32)
    for w in range(0, n, WARP):
        sl = slice(w, min(w + WARP, n))
        bt, bi, b2, b3, boxes, rows, swept = cluster_model(
            rays[sl], table, aabbs, groups)
        t[sl], idx[sl], s2[sl], s3[sl] = bt, bi, b2, b3
        counts[:, sl] = [boxes, np.full_like(boxes, rows),
                         np.full_like(boxes, swept)]
    return ((torch.from_numpy(t < _BIG), torch.from_numpy(t),
             torch.from_numpy(idx), torch.from_numpy(s2),
             torch.from_numpy(s3)), torch.from_numpy(counts))
