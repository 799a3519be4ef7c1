"""The threefry uniform draw, dispatched by device.

Wrapper of the CUDA kernel ``csrc/threefry.cu``, which replaces the
threefry2x32 hash and uniform conversion that XLA compiles for
``jax.random.uniform`` (there is no Pallas kernel for it). On a CUDA
device :func:`uniform` launches the kernel (or raises); on the CPU it runs
the plain version ``ops/rng.py::uniform_ref``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .. import _build
from ..device import DEFAULT_DEVICE, resolve_device
from .rng import Key, uniform_ref


def uniform(k: Key, shape: Sequence[int],
            device: "torch.device | str" = DEFAULT_DEVICE) -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` as a float32 tensor on ``device``
    (the card unless the caller asks for the CPU), bit for bit.
    ``uniform.launches`` counts the kernel launches."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return uniform_ref(k, shape, dev)
    if dev.type != "cuda":
        raise ValueError(f"uniform: unsupported device {dev}")
    shape = tuple(int(s) for s in shape)
    n = math.prod(shape)
    lib = _build.load()
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.pts_threefry_uniform(k.k1, k.k2, n, out.data_ptr(), stream)
    _build.check(err, "uniform")
    uniform.launches += 1
    return out


uniform.launches = 0
