"""K3: the hierarchical closest hit through the scene's BVH, dispatched by
device.

Wrapper of the CUDA kernel ``csrc/intersect_bvh.cu``, which replaces the
two TPU kernels of the ``hier`` backend,
``pathtracing_spectrum_tpu/ops/intersect_shortlist.py::_sl_kernel`` and
``pathtracing_spectrum_tpu/ops/intersect_worklist.py::_wl_kernel`` (one
function, two TPU grid layouts). For CUDA tensors :func:`intersect_bvh`
launches the kernel (or raises); for CPU tensors it runs the plain version
:func:`intersect_bvh_ref` (``ops/bvh.py``, the skip-link walk), re-exported
here beside the kernel.

The kernel walks node records that :func:`pack_bvh` builds once per scene
from the skip-link arrays of ``Scene.compile`` (``engine.make_intersector``
holds them): one 64-byte record per internal node with both children's
boxes and references, and the tree depth that sizes the walk's stack.
:func:`walk_model` is the kernel's walk for one ray in numpy float32,
line for line (record fetch, near-first order, stack, tie rule, inclusive
cull, the predicate), so the CPU tests reach the control flow the card
runs.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import _build
from ..constants import BIG
from .bvh import intersect_bvh_ref
from .intersect import CULL_MARGIN
from .intersect_cuda import check_rays, check_table, hit_outputs, on_cpu

__all__ = ["PackedBVH", "pack_bvh", "node_records", "intersect_bvh",
           "intersect_bvh_ref", "walk_model", "walk_model_batch"]

# stack entries a thread keeps in local memory (csrc/intersect_bvh.cu,
# kLocalStack); a deeper tree gets a scratch stack in device memory
LOCAL_STACK = 64


class PackedBVH(NamedTuple):
    """What K3 walks, built once per scene by :func:`pack_bvh`."""
    nodes: tuple            # (bvh_node_min, _max, _skip, _first, _count)
    records: torch.Tensor   # [1 + internal nodes, 16] float32, ints bitcast
    depth: int              # stack entries the walk needs


def node_records(node_min, node_max, node_skip, node_first, node_count):
    """Node records of a flat skip-link BVH (numpy arrays) and its depth.

    In preorder the left child of internal node ``i`` is ``i + 1`` and the
    right child ``skip[i + 1]``. Record ``1 + k`` belongs to the ``k``-th
    internal node: columns 0-5 the left child's box (lo, hi), 6-11 the
    right child's, 12-13 the two children's words and 14-15 their counts
    (int32 bit patterns). A child with count -1 is internal and its word is
    its record; a leaf's word is its first row, its count its row count.
    Record 0 holds the root in its left slot. A count-0 node without a
    child (the one node of an empty scene) is an empty leaf.

    The depth is the largest number of internal nodes on a path from the
    root to a leaf: a near-first walk never holds more stack entries.

    Returns (records [1 + internal, 16] float32, depth). Raises
    ``ValueError`` for arrays that are not a binary skip-link tree.
    """
    lo = np.asarray(node_min, np.float32).reshape(-1, 3)
    hi = np.asarray(node_max, np.float32).reshape(-1, 3)
    skip = np.asarray(node_skip, np.int64)
    first = np.asarray(node_first, np.int64)
    count = np.asarray(node_count, np.int64)
    nn = count.shape[0]
    internal = (count == 0) & (np.arange(nn) + 1 < nn)
    ids = np.flatnonzero(internal)
    left = ids + 1
    right = skip[left] if ids.size else left
    if ids.size and ((right >= nn).any() or (skip[right] != skip[ids]).any()):
        raise ValueError("node_records: the arrays are not a binary "
                         "skip-link BVH in preorder")
    rec_of = np.zeros(nn, np.int64)
    rec_of[ids] = 1 + np.arange(ids.size)

    def refs(c):
        return (np.where(internal[c], rec_of[c], first[c]),
                np.where(internal[c], -1, count[c]))

    def put_box(rows, cols, nodes):
        rows[:, cols[0]:cols[0] + 3] = lo[nodes]
        rows[:, cols[1]:cols[1] + 3] = hi[nodes]

    rec = np.zeros((1 + ids.size, 16), np.float32)
    words = rec.view(np.int32)
    root = np.zeros(1, np.int64)
    put_box(rec[:1], (0, 3), root)
    words[0, 12], words[0, 14] = (a[0] for a in refs(root))
    put_box(rec[1:], (0, 3), left)
    put_box(rec[1:], (6, 9), right)
    words[1:, 12], words[1:, 14] = refs(left)
    words[1:, 13], words[1:, 15] = refs(right)

    # internal ancestors of each node, one tree level a pass
    above = np.zeros(nn, np.int64)
    while ids.size:
        deeper = above[ids] + 1
        if (deeper <= above[left]).all():
            break
        above[left] = above[right] = deeper
    return rec, int(above.max())


def pack_bvh(node_min, node_max, node_skip, node_first, node_count
             ) -> PackedBVH:
    """Pack a scene's ``bvh_node_*`` tensors for K3 (:func:`node_records`),
    the records on the nodes' device."""
    nodes = (node_min, node_max, node_skip, node_first, node_count)
    rec, depth = node_records(*(a.cpu().numpy() for a in nodes))
    return PackedBVH(nodes, torch.from_numpy(rec).to(node_min.device), depth)


def intersect_bvh(rox, roy, roz, rdx, rdy, rdz, tri16, bvh: PackedBVH,
                  counts: Optional[torch.Tensor] = None):
    """Closest hit of N rays over the BVH-ordered [T, 16] table, walking
    the packed BVH (:func:`pack_bvh`).

    Returns (hit [N] bool, t [N] f32, idx [N] int32, s2 [N] f32, s3 [N] f32),
    t = BIG and idx = 0 on a miss: K1's result on the same table. With
    ``counts`` (a [2, N] int32 tensor on the card) the kernel also writes
    each ray's box tests and triangle tests into it.
    ``intersect_bvh.launches`` counts the kernel launches.
    """
    planes = (rox, roy, roz, rdx, rdy, rdz)
    if on_cpu(*planes, tri16, bvh.records):
        if counts is not None:
            raise ValueError("intersect_bvh: counts come from the kernel; "
                             "on the CPU use walk_model_batch")
        return intersect_bvh_ref(*planes, tri16, *bvh.nodes)
    name = "intersect_bvh"
    n, dev = check_rays(name, planes)
    check_table(name, "tri16", tri16, dev, (None, 16), align16=True)
    check_table(name, "records", bvh.records, dev, (None, 16), align16=True)
    if counts is not None:
        check_table(name, "counts", counts, dev, (2, n), dtype=torch.int32)
    scratch = (torch.empty((3, bvh.depth, n), dtype=torch.int32, device=dev)
               if bvh.depth > LOCAL_STACK else None)
    lib = _build.load()
    out = hit_outputs(n, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pts_intersect_bvh(
            *(p.data_ptr() for p in planes), tri16.data_ptr(),
            bvh.records.data_ptr(), n, bvh.depth,
            None if scratch is None else scratch.data_ptr(),
            None if counts is None else counts.data_ptr(),
            *(x.data_ptr() for x in out), stream)
    _build.check(err, name)
    intersect_bvh.launches += 1
    return out


intersect_bvh.launches = 0


# ---- the kernel's walk for one ray, in numpy float32 ------------------------

_F32 = np.float32
_ONE_PLUS_MARGIN = _F32(1.0 + CULL_MARGIN)
_MARGIN = _F32(CULL_MARGIN)
_INF = _F32(math.inf)
_BIG = _F32(BIG)
_ZERO = _F32(0.0)


def _relax(t):
    return t * _ONE_PLUS_MARGIN + _MARGIN


def _dot3(ax, ay, az, bx, by, bz):
    return (ax * bx + ay * by) + az * bz


def _box_enter(o, inv, zero, lo, hi, best_t):
    """tri_hit.cuh::box_enter: (entered, entry distance)."""
    near = far = _ZERO
    for a in range(3):
        t0 = (lo[a] - o[a]) * inv[a]
        t1 = (hi[a] - o[a]) * inv[a]
        lt = t0 < t1
        n_a = t0 if lt else t1
        f_a = t1 if lt else t0
        if zero[a]:
            inside = o[a] >= lo[a] and o[a] <= hi[a]
            n_a = -_INF if inside else _INF
            f_a = _INF if inside else -_INF
        near = n_a if a == 0 else (near if near > n_a else n_a)
        far = f_a if a == 0 else (far if far < f_a else f_a)
    far_r = _relax(far)
    return (bool(near <= far_r and far_r >= 0 and near <= _relax(best_t)),
            near)


def _tri_update(o, d, r, idx, best):
    """tri_hit.cuh::tri_update on ``best = [t, i, s2, s3]``: every term of
    the predicate, then the tie rule (a smaller t, or an equal t at a lower
    index)."""
    denom = _dot3(d[0], d[1], d[2], r[0], r[1], r[2])
    ro_n = _dot3(o[0], o[1], o[2], r[0], r[1], r[2])
    safe = _F32(1.0) if denom == 0 else denom
    t = (r[12] - ro_n) / safe
    px, py, pz = o[0] + t * d[0], o[1] + t * d[1], o[2] + t * d[2]
    s1 = _dot3(px, py, pz, r[3], r[4], r[5]) - r[13]
    s2 = _dot3(px, py, pz, r[6], r[7], r[8]) - r[14]
    s3 = _dot3(px, py, pz, r[9], r[10], r[11]) - r[15]
    valid = denom != 0 and t >= 0 and s1 >= 0 and s2 >= 0 and s3 >= 0
    if valid and (t < best[0] or (t == best[0] and idx < best[1])):
        best[:] = [t, idx, s2, s3]


def walk_model(ray: Sequence[float], tri16: np.ndarray, records: np.ndarray):
    """K3's walk for one ray (``csrc/intersect_bvh.cu``, line for line),
    in numpy float32.

    ``ray``: (ox, oy, oz, dx, dy, dz); ``tri16``: [T, 16] float32;
    ``records``: :func:`node_records`. Returns (hit, t, idx, s2, s3, box
    tests, triangle tests).
    """
    o = [_F32(v) for v in ray[:3]]
    d = [_F32(v) for v in ray[3:]]
    best = [_BIG, 0, _ZERO, _ZERO]
    boxes = tris = 0
    words = records.view(np.int32)
    if any(v != 0 for v in d):
        zero = [v == 0 for v in d]
        with np.errstate(all="ignore"):
            inv = [_F32(1.0) if z else _F32(1.0) / v for z, v in zip(zero, d)]
        stack = []

        def pop():
            while stack:
                w, c, e = stack.pop()
                if e <= _relax(best[0]):
                    return w, c
            return None

        with np.errstate(all="ignore"):
            q = records[0]
            live, _ = _box_enter(o, inv, zero, q[0:3], q[3:6], best[0])
            boxes += 1
            word, count = int(words[0, 12]), int(words[0, 14])
            while live:
                while count < 0:                 # internal: nearer first
                    q, qi = records[word], words[word]
                    hl, near_l = _box_enter(o, inv, zero, q[0:3], q[3:6],
                                            best[0])
                    hr, near_r = _box_enter(o, inv, zero, q[6:9], q[9:12],
                                            best[0])
                    boxes += 2
                    wl, wr, cl, cr = (int(v) for v in qi[12:16])
                    if hl and hr:
                        if near_r < near_l:
                            stack.append((wl, cl, near_l))
                            word, count = wr, cr
                        else:
                            stack.append((wr, cr, near_r))
                            word, count = wl, cl
                    elif hl:
                        word, count = wl, cl
                    elif hr:
                        word, count = wr, cr
                    else:
                        nxt = pop()
                        if nxt is None:
                            live = False
                            break
                        word, count = nxt
                if not live:
                    break
                for k in range(count):           # a leaf, ascending
                    _tri_update(o, d, tri16[word + k], word + k, best)
                tris += count
                nxt = pop()
                live = nxt is not None
                if live:
                    word, count = nxt
    t, i, s2, s3 = best
    return bool(t < _BIG), t, i, s2, s3, boxes, tris


def walk_model_batch(planes, tri16: torch.Tensor, bvh: PackedBVH):
    """:func:`walk_model` over CPU ray planes: (hit, t, idx, s2, s3) as the
    kernel returns them, and the [2, N] int32 test counts."""
    cols = np.stack([p.numpy() for p in planes], axis=1)
    table = tri16.numpy()
    records = bvh.records.cpu().numpy()
    res = [walk_model(ray, table, records) for ray in cols]
    hit, t, idx, s2, s3, boxes, tris = (list(c) for c in zip(*res))
    return ((torch.tensor(hit), torch.tensor(np.array(t, np.float32)),
             torch.tensor(idx, dtype=torch.int32),
             torch.tensor(np.array(s2, np.float32)),
             torch.tensor(np.array(s3, np.float32))),
            torch.tensor([boxes, tris], dtype=torch.int32))
