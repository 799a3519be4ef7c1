"""K2: the per-hit attribute fetch, dispatched by device.

Wrapper of the CUDA kernel ``csrc/fetch_rows.cu``, which replaces the TPU
kernel ``pathtracing_spectrum_tpu/ops/fetch_pallas.py::_fetch_kernel``.
For CUDA tensors :func:`fetch_rows` launches the kernel (or raises); for
CPU tensors it runs the plain version :func:`fetch_rows_ref`.
"""

from __future__ import annotations

import torch

from .. import _build


def fetch_rows_ref(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain torch: ``out[:, i] = table[idx[i]]``, 0 for idx outside [0, T).

    Returns a contiguous [F, N] float32 tensor.
    """
    t_count = table.shape[0]
    valid = (idx >= 0) & (idx < t_count)
    rows = table.index_select(0, idx.clamp(0, max(t_count - 1, 0)).long())
    return torch.where(valid[:, None], rows, 0.0).t().contiguous()


def fetch_rows(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """[F, N] attribute planes for each ray's row of the [T, F] table.

    ``fetch_rows.launches`` counts the kernel launches.
    """
    if idx.device.type == "cpu" and table.device.type == "cpu":
        return fetch_rows_ref(idx, table)
    dev = idx.device
    if dev.type != "cuda":
        raise ValueError(f"fetch_rows: unsupported device {dev}")
    if idx.dtype != torch.int32 or idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("fetch_rows: idx must be a contiguous [N] int32 "
                         "tensor")
    if (table.device != dev or table.dtype != torch.float32
            or table.dim() != 2 or not table.is_contiguous()):
        raise ValueError("fetch_rows: table must be a contiguous [T, F] "
                         f"float32 tensor on {dev}")
    n = idx.shape[0]
    t_count, f_count = table.shape
    lib = _build.load()
    out = torch.empty((f_count, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pts_fetch_rows(idx.data_ptr(), table.data_ptr(), n,
                                 t_count, f_count, out.data_ptr(), stream)
    _build.check(err, "fetch_rows")
    fetch_rows.launches += 1
    return out


fetch_rows.launches = 0
