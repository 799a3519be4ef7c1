"""K1: the dense closest-hit sweep, dispatched by device.

Wrapper of the CUDA kernel ``csrc/intersect_dense.cu``, which replaces the
TPU kernel ``pathtracing_spectrum_tpu/ops/intersect_pallas.py::_kernel``.
For CUDA tensors :func:`intersect_dense` launches the kernel (or raises);
for CPU tensors it runs the plain version :func:`intersect_dense_ref`
(``ops/intersect.py``), re-exported here beside the kernel.

The argument checks and output allocation here are shared by the other
closest-hit wrappers (K3 ``ops/intersect_hier_cuda.py``, K4
``ops/intersect_cluster_cuda.py``).
"""

from __future__ import annotations

import torch

from .. import _build
from .intersect import intersect_dense_ref


def on_cpu(*tensors) -> bool:
    return all(x.device.type == "cpu" for x in tensors)


def check_rays(name: str, planes):
    """The six ray planes must be contiguous [N] float32 on one CUDA
    device; returns (N, device)."""
    n = planes[0].shape[0]
    dev = planes[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for p in planes:
        if (p.device != dev or p.dtype != torch.float32 or p.shape != (n,)
                or not p.is_contiguous()):
            raise ValueError(f"{name}: ray planes must be contiguous "
                             f"[{n}] float32 on {dev}")
    return n, dev


def check_table(name: str, what: str, table: torch.Tensor, dev,
                shape, dtype=torch.float32, align16: bool = False) -> None:
    """``table`` must be a contiguous ``dtype`` tensor on ``dev`` whose
    shape matches ``shape`` (None for any size on that axis); with
    ``align16`` its address must allow 16-byte loads."""
    ok = (table.device == dev and table.dtype == dtype
          and table.dim() == len(shape) and table.is_contiguous()
          and all(w is None or s == w for s, w in zip(table.shape, shape))
          and (not align16 or table.data_ptr() % 16 == 0))
    if not ok:
        dims = ", ".join("*" if w is None else str(w) for w in shape)
        raise ValueError(f"{name}: {what} must be a contiguous [{dims}] "
                         f"{dtype} tensor on {dev}"
                         + (", 16-byte aligned" if align16 else ""))


def hit_outputs(n: int, dev):
    """Empty (hit, t, idx, s2, s3) planes for a closest-hit kernel."""
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(n, **f32), torch.empty(n, dtype=torch.int32,
                                               device=dev),
            torch.empty(n, **f32), torch.empty(n, **f32))


def intersect_dense(rox, roy, roz, rdx, rdy, rdz, tri16: torch.Tensor):
    """Closest hit of N rays over all rows of the packed [T, 16] table.

    Returns (hit [N] bool, t [N] f32, idx [N] int32, s2 [N] f32, s3 [N] f32),
    t = BIG and idx = 0 on a miss. ``intersect_dense.launches`` counts the
    kernel launches.
    """
    planes = (rox, roy, roz, rdx, rdy, rdz)
    if on_cpu(*planes, tri16):
        return intersect_dense_ref(*planes, tri16)
    n, dev = check_rays("intersect_dense", planes)
    check_table("intersect_dense", "tri16", tri16, dev, (None, 16),
                align16=True)
    lib = _build.load()
    out = hit_outputs(n, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pts_intersect_dense(
            *(p.data_ptr() for p in planes), tri16.data_ptr(), n,
            tri16.shape[0], *(x.data_ptr() for x in out), stream)
    _build.check(err, "intersect_dense")
    intersect_dense.launches += 1
    return out


intersect_dense.launches = 0
