"""K4: the cluster-culled closest hit, dispatched by device.

Wrapper of the CUDA kernel ``csrc/intersect_cluster.cu``, which replaces
the TPU kernel ``pathtracing_spectrum_tpu/ops/intersect_pallas.py::
_cluster_kernel`` (with ``_cluster_group``). For CUDA tensors
:func:`intersect_cluster` launches the kernel (or raises); for CPU tensors
it runs the plain version :func:`intersect_cluster_ref`.
"""

from __future__ import annotations

import torch

from .. import _build
from ..constants import BIG
from .intersect import box_hits, intersect_dense_ref, ray_slab_setup
from .intersect_cuda import check_rays, check_table, hit_outputs, on_cpu

# triangle rows per cluster AABB (the JAX package's intersect_pallas.CLUSTER)
CLUSTER = 128


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


def intersect_cluster(rox, roy, roz, rdx, rdy, rdz, tri16, cluster_aabbs):
    """Closest hit of N rays over the BVH-ordered [T, 16] table with
    per-cluster box culling.

    Returns (hit [N] bool, t [N] f32, idx [N] int32, s2 [N] f32, s3 [N] f32),
    t = BIG and idx = 0 on a miss: K1's result on the same table.
    ``intersect_cluster.launches`` counts the kernel launches.
    """
    planes = (rox, roy, roz, rdx, rdy, rdz)
    if on_cpu(*planes, tri16, cluster_aabbs):
        return intersect_cluster_ref(*planes, tri16, cluster_aabbs)
    name = "intersect_cluster"
    n, dev = check_rays(name, planes)
    check_table(name, "tri16", tri16, dev, (None, 16), align16=True)
    n_clusters = -(-tri16.shape[0] // CLUSTER)
    check_table(name, "cluster_aabbs", cluster_aabbs, dev,
                (max(n_clusters, 1), 8))
    lib = _build.load()
    out = hit_outputs(n, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pts_intersect_cluster(
            *(p.data_ptr() for p in planes), tri16.data_ptr(),
            cluster_aabbs.data_ptr(), n, tri16.shape[0],
            *(x.data_ptr() for x in out), stream)
    _build.check(err, name)
    intersect_cluster.launches += 1
    return out


intersect_cluster.launches = 0
