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
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..constants import BIG

# [N, C] elements per chunk of the plain sweep: bounds its temporaries
# (~15 of them) to a few hundred MB at the main path's ray count.
_REF_CHUNK_ELEMS = 1 << 22


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
        nx, ny, nz, k1x, k1y, k1z, k2x, k2y, k2z, k3x, k3y, k3z, \
            c0, c1, c2, c3 = (tri[:, j][None, :] for j in range(16))
        denom = o[3] * nx + o[4] * ny + o[5] * nz              # [N, C]
        ro_n = o[0] * nx + o[1] * ny + o[2] * nz
        safe = torch.where(denom == 0.0, 1.0, denom)
        t = (c0 - ro_n) / safe
        px = o[0] + t * o[3]
        py = o[1] + t * o[4]
        pz = o[2] + t * o[5]
        s1 = px * k1x + py * k1y + pz * k1z - c1
        s2 = px * k2x + py * k2y + pz * k2z - c2
        s3 = px * k3x + py * k3y + pz * k3z - c3
        valid = ((denom != 0.0) & (t >= 0.0)
                 & (s1 >= 0.0) & (s2 >= 0.0) & (s3 >= 0.0))
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
