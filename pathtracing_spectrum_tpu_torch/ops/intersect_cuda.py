"""K1: the dense closest-hit sweep, dispatched by device.

Wrapper of the CUDA kernel ``csrc/intersect_dense.cu``, which replaces the
TPU kernel ``pathtracing_spectrum_tpu/ops/intersect_pallas.py::_kernel``.
For CUDA tensors :func:`intersect_dense` launches the kernel (or raises);
for CPU tensors it runs the plain version :func:`intersect_dense_ref`
(``ops/intersect.py``), re-exported here beside the kernel.
"""

from __future__ import annotations

import torch

from .. import _build
from .intersect import intersect_dense_ref


def intersect_dense(rox, roy, roz, rdx, rdy, rdz, tri16: torch.Tensor):
    """Closest hit of N rays over all rows of the packed [T, 16] table.

    Returns (hit [N] bool, t [N] f32, idx [N] int32, s2 [N] f32, s3 [N] f32),
    t = BIG and idx = 0 on a miss. ``intersect_dense.launches`` counts the
    kernel launches.
    """
    planes = (rox, roy, roz, rdx, rdy, rdz)
    if all(p.device.type == "cpu" for p in planes + (tri16,)):
        return intersect_dense_ref(*planes, tri16)
    n = rox.shape[0]
    dev = rox.device
    if dev.type != "cuda":
        raise ValueError(f"intersect_dense: unsupported device {dev}")
    for p in planes:
        if (p.device != dev or p.dtype != torch.float32 or p.shape != (n,)
                or not p.is_contiguous()):
            raise ValueError("intersect_dense: ray planes must be contiguous "
                             f"[{n}] float32 on {dev}")
    if (tri16.device != dev or tri16.dtype != torch.float32
            or tri16.dim() != 2 or tri16.shape[1] != 16
            or not tri16.is_contiguous()):
        raise ValueError("intersect_dense: tri16 must be a contiguous "
                         f"[T, 16] float32 tensor on {dev}")
    lib = _build.load()
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    idx = torch.empty(n, dtype=torch.int32, device=dev)
    s2 = torch.empty(n, dtype=torch.float32, device=dev)
    s3 = torch.empty(n, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pts_intersect_dense(
            *(p.data_ptr() for p in planes), tri16.data_ptr(), n,
            tri16.shape[0], hit.data_ptr(), t.data_ptr(), idx.data_ptr(),
            s2.data_ptr(), s3.data_ptr(), stream)
    _build.check(err, "intersect_dense")
    intersect_dense.launches += 1
    return hit, t, idx, s2, s3


intersect_dense.launches = 0
