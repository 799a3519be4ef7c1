"""K3: the hierarchical closest hit through the flat BVH, dispatched by
device.

Wrapper of the CUDA kernel ``csrc/intersect_bvh.cu``, which replaces the
two TPU kernels of the ``hier`` backend,
``pathtracing_spectrum_tpu/ops/intersect_shortlist.py::_sl_kernel`` and
``pathtracing_spectrum_tpu/ops/intersect_worklist.py::_wl_kernel`` (one
function, two TPU grid layouts). For CUDA tensors :func:`intersect_bvh`
launches the kernel (or raises); for CPU tensors it runs the plain version
:func:`intersect_bvh_ref` (``ops/bvh.py``), re-exported here beside the
kernel.
"""

from __future__ import annotations

import torch

from .. import _build
from .bvh import intersect_bvh_ref
from .intersect_cuda import check_rays, check_table, hit_outputs, on_cpu

__all__ = ["intersect_bvh", "intersect_bvh_ref"]


def intersect_bvh(rox, roy, roz, rdx, rdy, rdz, tri16, node_min, node_max,
                  node_skip, node_first, node_count):
    """Closest hit of N rays over the BVH-ordered [T, 16] table, walking
    the flat BVH (``SceneData.bvh_node_*``).

    Returns (hit [N] bool, t [N] f32, idx [N] int32, s2 [N] f32, s3 [N] f32),
    t = BIG and idx = 0 on a miss: K1's result on the same table.
    ``intersect_bvh.launches`` counts the kernel launches.
    """
    planes = (rox, roy, roz, rdx, rdy, rdz)
    nodes = (node_min, node_max, node_skip, node_first, node_count)
    if on_cpu(*planes, tri16, *nodes):
        return intersect_bvh_ref(*planes, tri16, *nodes)
    name = "intersect_bvh"
    n, dev = check_rays(name, planes)
    check_table(name, "tri16", tri16, dev, (None, 16), align16=True)
    nn = node_min.shape[0] if node_min.dim() == 2 else -1
    check_table(name, "node_min", node_min, dev, (nn, 3))
    check_table(name, "node_max", node_max, dev, (nn, 3))
    for what, arr in (("node_skip", node_skip), ("node_first", node_first),
                      ("node_count", node_count)):
        check_table(name, what, arr, dev, (nn,), dtype=torch.int32)
    lib = _build.load()
    out = hit_outputs(n, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pts_intersect_bvh(
            *(p.data_ptr() for p in planes), tri16.data_ptr(),
            *(a.data_ptr() for a in nodes), n, nn,
            *(x.data_ptr() for x in out), stream)
    _build.check(err, name)
    intersect_bvh.launches += 1
    return out


intersect_bvh.launches = 0
