"""Ray-triangle closest hit: host precompute and the plain torch sweep.

Port of ``pathtracing_spectrum_tpu/ops/intersect.py``. Semantics are the
reference's (mesh.cpp:283-295 plane hit + blackpawn same-side test) in the
K-vector form: with per-triangle constants ``K1, K2, K3`` and
``c = (v1.n, v2.K1, v1.K2, v1.K3)``,

    t = (c0 - ro.n) / (rd.n),  p = ro + t*rd,  s_i = p.K_i - c_i,

valid iff ``rd.n != 0``, ``t >= 0`` and ``s1, s2, s3 >= 0``. The minimum t
wins, the lowest index wins a tie, zero rows never hit.

:func:`intersect_dense_ref` is the plain version of the CUDA kernel
``csrc/intersect_dense.cu`` (wrapper: ``ops/intersect_cuda.py``). Both
write every expression in the operation order of the JAX sweep
(``_chunk_hits``): each dot product left to right, ``safe = denom == 0 ? 1
: denom``, an IEEE division, the hit point, then the same-side terms.
Unlike the TPU kernel, both return the winner's s2/s3 (barycentric
numerators), so the engine reads alpha/beta from them.

:func:`tri_hits` (the predicate) and :func:`box_hits` (the culling box
test) are the plain halves of ``csrc/tri_hit.cuh``, which K1, K3 and K4
share; the plain versions of K3 (``ops/bvh.py``) and K4
(``ops/intersect_cluster_cuda.py``) are built from them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..constants import BIG

# [N, C] elements per chunk of the plain sweep: bounds its temporaries
# (~15 of them) to a few hundred MB at the main path's ray count.
_REF_CHUNK_ELEMS = 1 << 22

# Margin of the hierarchical kernels' box tests, relative and absolute, as
# the float32 values the CUDA sources spell as hex literals.
CULL_MARGIN = 1e-4
_ONE_PLUS_MARGIN = float(np.float32(1.0 + CULL_MARGIN))
_MARGIN = float(np.float32(CULL_MARGIN))
_INF = float("inf")


def precompute_intersect_tables(v1, e1, e2, face_n
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]:
    """Host-side per-triangle constants for the K-vector inside test.

    Returns (k1, k2, k3 [T,3], consts [T,4]) with
    consts = (v1n, c1, c2, c3) = (v1.n, v2.K1, v1.K2, v1.K3).
    """
    v1 = np.asarray(v1, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    n = np.asarray(face_n, np.float64)
    v2 = v1 + e1
    ba1 = e2 - e1
    k1 = np.cross(np.cross(ba1, -e1), ba1)
    k2 = np.cross(np.cross(e2, e1), e2)
    k3 = np.cross(np.cross(e1, e2), e1)
    consts = np.stack([
        np.einsum("ij,ij->i", v1, n),
        np.einsum("ij,ij->i", v2, k1),
        np.einsum("ij,ij->i", v1, k2),
        np.einsum("ij,ij->i", v1, k3),
    ], axis=1)
    return (k1.astype(np.float32), k2.astype(np.float32),
            k3.astype(np.float32), consts.astype(np.float32))


def pack_tri16(tri_n, tri_k1, tri_k2, tri_k3, tri_consts) -> torch.Tensor:
    """[T, 16] packed table (n | K1 | K2 | K3 | c0 c1 c2 c3), contiguous."""
    return torch.cat([tri_n, tri_k1, tri_k2, tri_k3, tri_consts],
                     dim=1).contiguous()


def tri_hits(ox, oy, oz, dx, dy, dz, cols):
    """The triangle predicate on broadcast operands (plain torch): the ray
    planes ``ox..dz`` against the 16 table columns ``cols`` (n | K1 | K2 |
    K3 | c0..c3), every expression in the kernels' operation order
    (``csrc/tri_hit.cuh``). Returns (valid, t, s2, s3)."""
    nx, ny, nz, k1x, k1y, k1z, k2x, k2y, k2z, k3x, k3y, k3z, \
        c0, c1, c2, c3 = cols
    denom = dx * nx + dy * ny + dz * nz
    ro_n = ox * nx + oy * ny + oz * nz
    safe = torch.where(denom == 0.0, 1.0, denom)
    t = (c0 - ro_n) / safe
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    s1 = px * k1x + py * k1y + pz * k1z - c1
    s2 = px * k2x + py * k2y + pz * k2z - c2
    s3 = px * k3x + py * k3y + pz * k3z - c3
    valid = ((denom != 0.0) & (t >= 0.0)
             & (s1 >= 0.0) & (s2 >= 0.0) & (s3 >= 0.0))
    return valid, t, s2, s3


def relax(t):
    """``t * (1 + CULL_MARGIN) + CULL_MARGIN``: the bound a box test may
    reach before it culls (the margin of the JAX package's
    ``ray_exit_caps``/``tighten_caps``)."""
    return t * _ONE_PLUS_MARGIN + _MARGIN


def ray_slab_setup(rdx, rdy, rdz):
    """Per-ray (inv, zero) planes of the box test: ``zero[a]`` is ``d_a ==
    0`` and ``inv[a]`` is ``1 / d_a`` where it is not (1 where it is)."""
    zero = [d == 0.0 for d in (rdx, rdy, rdz)]
    inv = [1.0 / torch.where(z, 1.0, d)
           for z, d in zip(zero, (rdx, rdy, rdz))]
    return inv, zero


def box_hits(o, inv, zero, lo, hi, best_t):
    """Box test of the hierarchical kernels (plain torch, the arithmetic of
    ``csrc/tri_hit.cuh::box_hit``).

    ``o``, ``inv``, ``zero``: 3 ray planes each (:func:`ray_slab_setup`);
    ``lo``, ``hi``: 3 box bounds each, broadcastable to the planes;
    ``best_t``: the running closest hit. An axis with a zero direction
    component bounds nothing when the origin lies in its slab and culls
    when it does not: ``(b - o) / 0`` is never formed, so no 0 * inf NaN.
    The box is kept when its slab interval overlaps [0, best_t] widened by
    :func:`relax` at both ends, so the few-ulp difference between slab and
    triangle-plane arithmetic never culls the true winner. Min and max are
    written as selects, as the kernels write them."""
    near = far = None
    for a in range(3):
        t0 = (lo[a] - o[a]) * inv[a]
        t1 = (hi[a] - o[a]) * inv[a]
        lt = t0 < t1
        n_a = torch.where(lt, t0, t1)
        f_a = torch.where(lt, t1, t0)
        inside = (o[a] >= lo[a]) & (o[a] <= hi[a])
        n_a = torch.where(zero[a], torch.where(inside, -_INF, _INF), n_a)
        f_a = torch.where(zero[a], torch.where(inside, _INF, -_INF), f_a)
        near = n_a if near is None else torch.where(near > n_a, near, n_a)
        far = f_a if far is None else torch.where(far < f_a, far, f_a)
    far_r = relax(far)
    return (near <= far_r) & (far_r >= 0.0) & (near <= relax(best_t))


def intersect_dense_ref(rox, roy, roz, rdx, rdy, rdz, tri16: torch.Tensor):
    """Closest hit of N rays over all T rows of ``tri16`` (plain torch).

    Args:
      rox..rdz: [N] float32 ray component planes.
      tri16: [T, 16] float32 packed table (:func:`pack_tri16`).

    Returns (hit [N] bool, t [N] f32, idx [N] int32, s2 [N] f32, s3 [N] f32);
    t = BIG, idx = 0, s2 = s3 = 0 where nothing is hit.
    """
    n = rox.shape[0]
    t_count = tri16.shape[0]
    dev = rox.device
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_i = torch.zeros(n, dtype=torch.int32, device=dev)
    best_s2 = torch.zeros(n, dtype=torch.float32, device=dev)
    best_s3 = torch.zeros(n, dtype=torch.float32, device=dev)
    chunk = max(1, min(t_count, _REF_CHUNK_ELEMS // max(n, 1)))
    o = [c[:, None] for c in (rox, roy, roz, rdx, rdy, rdz)]
    for start in range(0, t_count, chunk):
        tri = tri16[start:start + chunk]
        valid, t, s2, s3 = tri_hits(*o, [tri[:, j][None, :]
                                         for j in range(16)])   # [N, C]
        tt = torch.where(valid, t, BIG)
        # first-index argmin inside the chunk, strict < across chunks:
        # together the lowest index wins a tie
        local_t, local_i = torch.min(tt, dim=1)
        better = local_t < best_t
        pick = local_i[:, None]
        best_i = torch.where(better, (local_i + start).to(torch.int32), best_i)
        best_t = torch.where(better, local_t, best_t)
        best_s2 = torch.where(better, s2.gather(1, pick)[:, 0], best_s2)
        best_s3 = torch.where(better, s3.gather(1, pick)[:, 0], best_s3)
    return best_t < BIG, best_t, best_i, best_s2, best_s3
