"""Hand-built cases for K3's walk and K4's cluster sweep, shared by the CPU
tests (``test_torch_hier.py``, ``test_torch_cluster.py``), the card tests
(``test_torch_cuda.py``) and ``chip_smoke.py``. jax-free, so the card
tests run where jax is not installed."""

import numpy as np
import torch

from pathtracing_spectrum_tpu_torch.ops.intersect import (
    pack_tri16, precompute_intersect_tables)
from pathtracing_spectrum_tpu_torch.scene import build_cluster_aabbs


def _flat_rows(v1):
    """[T, 16] table of unit right triangles at ``v1`` facing +z, and their
    boxes (flat boxes get 1e-3 of depth, as the SAH builder gives them)."""
    t = v1.shape[0]
    e1 = np.tile([1.0, 0.0, 0.0], (t, 1))
    e2 = np.tile([0.0, 1.0, 0.0], (t, 1))
    fn = np.tile([0.0, 0.0, 1.0], (t, 1)).astype(np.float32)
    tri16 = pack_tri16(*(torch.from_numpy(a) for a in
                         (fn,) + precompute_intersect_tables(v1, e1, e2, fn)))
    lo = np.minimum(v1, np.minimum(v1 + e1, v1 + e2))
    hi = np.maximum(v1, np.maximum(v1 + e1, v1 + e2)) + [0.0, 0.0, 1e-3]
    return tri16, lo, hi


def _nodes(mins, maxs, skip, first, count):
    f32 = dict(dtype=torch.float32)
    i32 = dict(dtype=torch.int32)
    return (torch.tensor(np.array(mins), **f32),
            torch.tensor(np.array(maxs), **f32), torch.tensor(skip, **i32),
            torch.tensor(first, **i32), torch.tensor(count, **i32))


def chain_bvh(depth):
    """A caterpillar tree: internal node k has leaf k (one row) on the left
    and the rest on the right. Leaf k lies at z = depth - k, so a ray along
    +z enters the rest's box before leaf k's and the near-first walk pushes
    every leaf: its stack fills to ``depth``. Returns (tri16, node
    arrays)."""
    t = depth + 1
    v1 = np.zeros((t, 3))
    v1[:, 2] = depth - np.arange(t)
    tri16, lo, hi = _flat_rows(v1)
    mins, maxs, skips, firsts, counts = [], [], [], [], []
    for k in range(t):                 # preorder: internal k, leaf k, ...
        if k < t - 1:
            mins.append(lo[k:].min(0))
            maxs.append(hi[k:].max(0))
            skips.append(0)            # set below: the end of the tree
            firsts.append(k)
            counts.append(0)
        mins.append(lo[k])
        maxs.append(hi[k])
        skips.append(len(skips) + 1)
        firsts.append(k)
        counts.append(1)
    for k in range(t - 1):
        skips[2 * k] = len(skips)
    return tri16, _nodes(mins, maxs, skips, firsts, counts)


def tie_case():
    """One triangle at two rows (1 and 2) in two leaves: rows 0-1 and 2-3
    under one root. Row 3, which the ray misses, pulls the right leaf's box
    toward the ray, so a near-first walk enters it first and meets row 2
    before row 1. Returns (tri16, node arrays, ray planes); the closest
    hit is row 1."""
    v1 = np.array([[5.0, 5.0, 2.0], [0.0, 0.0, 0.0],
                   [0.0, 0.0, 0.0], [5.0, 5.0, -0.5]])
    tri16, lo, hi = _flat_rows(v1)
    nodes = _nodes([lo.min(0), lo[:2].min(0), lo[2:].min(0)],
                   [hi.max(0), hi[:2].max(0), hi[2:].max(0)],
                   [3, 2, 3], [0, 0, 2], [0, 2, 2])
    planes = [torch.tensor([v], dtype=torch.float32)
              for v in (0.1, 0.1, -1.0, 0.0, 0.0, 1.0)]
    return tri16, nodes, planes


def cluster_tie_case():
    """One triangle at rows 5 and 1030 of a 1,152-row table: in cluster 0
    (group 0) and cluster 8 (group 1). Row 1031, which the ray misses,
    stretches cluster 8's box toward the ray, so cluster 8 has the nearer
    entry and a nearest-first sweep meets row 1030 first. Every other row
    lies beside the ray, at x >= 100. Returns (tri16, cluster_aabbs, ray
    planes); the closest hit is row 5."""
    t = 9 * 128
    v1 = np.zeros((t, 3))
    v1[:, 0] = 100.0 + 3.0 * np.arange(t)
    v1[:, 2] = 5.0
    v1[5] = v1[1030] = 0.0
    v1[1031] = [5.0, 5.0, -0.5]
    tri16, lo, hi = _flat_rows(v1)
    caabb = torch.from_numpy(build_cluster_aabbs(lo.astype(np.float32),
                                                 hi.astype(np.float32)))
    planes = [torch.tensor([v], dtype=torch.float32)
              for v in (0.1, 0.1, -1.0, 0.0, 0.0, 1.0)]
    return tri16, caabb, planes


def many_clusters_case():
    """600 clusters stacked along +z (cluster c at z = 600 - c), each with
    one unit triangle at x, y in [0, 1] in its first row and the rest
    beside the rays, at x, y = 2: every ray enters every cluster box, so a
    warp lists more clusters than its list holds and sweeps them in two
    windows. Rays: 39 along +z from z = -1 through (0.25 + k/100, 0.25),
    and one parked. Returns (tri16, cluster_aabbs, ray planes); the
    closest hit is row 599 * 128, at t = 2."""
    c = np.repeat(np.arange(600), 128)
    v1 = np.full((c.size, 3), 2.0)
    v1[:, 2] = 600.0 - c
    v1[::128, :2] = 0.0
    tri16, lo, hi = _flat_rows(v1)
    caabb = torch.from_numpy(build_cluster_aabbs(lo.astype(np.float32),
                                                 hi.astype(np.float32)))
    ro = np.zeros((40, 3), np.float32)
    ro[:, 0] = 0.25 + np.arange(40) / 100.0
    ro[:, 1], ro[:, 2] = 0.25, -1.0
    rd = np.tile(np.float32([0.0, 0.0, 1.0]), (40, 1))
    ro[39], rd[39] = 1e30, 0.0
    planes = [torch.from_numpy(np.ascontiguousarray(a[:, k]))
              for a in (ro, rd) for k in range(3)]
    return tri16, caabb, planes


def scene_rays(nodes, n_random, seed):
    """Rays through a scene: from points inside the root box in seeded
    random directions, every 9th parked."""
    rng = np.random.default_rng(seed)
    lo, hi = nodes[0][0].numpy(), nodes[1][0].numpy()
    ro = rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo),
                     (n_random, 3))
    rd = rng.normal(0, 1, (n_random, 3))
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    ro[::9], rd[::9] = 1e30, 0.0
    return ro.astype(np.float32), rd.astype(np.float32)
