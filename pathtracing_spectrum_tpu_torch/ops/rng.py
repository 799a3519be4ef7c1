"""``jax.random``'s threefry key schedule, as the JAX package uses it.

Port of the pieces of ``jax/_src/prng.py`` and ``jax/_src/random.py``
(JAX 0.9.0, ``jax_threefry_partitionable=True``) that the engine reaches,
bit for bit:

- :func:`key` is ``jax.random.key(seed)``: the pair ``(0, seed)`` for a
  32-bit seed (``_threefry_seed``);
- :func:`fold_in` is ``threefry_2x32(key, threefry_seed(data))``
  (``_threefry_fold_in``): one threefry block on the counter ``(0, data)``;
- :func:`split` is ``_threefry_split_foldlike``: key ``i`` is the block of
  the counter ``(0, i)``;
- :func:`uniform_ref` is ``jax.random.uniform(key, shape)`` in float32:
  ``bits = y1 ^ y2`` of the block of the row-major flat index split into
  ``(hi, lo)`` 32-bit words (``iota_2x32_shape``), then
  ``bitcast((bits >> 9) | 0x3F800000) - 1``.

Keys are host-side pairs of Python integers, so deriving one costs no
device launch; only the bulk draw runs on the device, through the kernel
``csrc/threefry.cu`` (``ops/rng_cuda.py::uniform``). The plain version
here works on int64 tensors masked to 32 bits: torch has no complete
uint32 arithmetic and its int32 right shift is arithmetic.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Sequence

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


class Key(NamedTuple):
    """A threefry key: the two uint32 words of ``jax.random.key_data``."""

    k1: int
    k2: int


def key(seed: int) -> Key:
    """``jax.random.key(seed)`` for a seed that fits 32 bits (JAX's default
    without x64 truncates the seed to its low word)."""
    return Key(0, int(seed) & MASK32)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1: int, k2: int, x1, x2):
    """One threefry-2x32 block (20 rounds) on Python integers, or
    elementwise on int64 tensors holding uint32 values (no sum of two
    such values overflows int64, and ``>>`` of a non-negative int64 is a
    logical shift)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1, x2 = (x1 + ks[0]) & MASK32, (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + (ks[(i + 2) % 3] + i + 1)) & MASK32
    return x1, x2


def fold_in(k: Key, data: int) -> Key:
    """``jax.random.fold_in(k, data)`` for a 32-bit ``data``."""
    return Key(*threefry2x32(k.k1, k.k2, 0, int(data) & MASK32))


def split(k: Key, num: int = 2) -> List[Key]:
    """``jax.random.split(k, num)``: ``num`` keys."""
    return [Key(*threefry2x32(k.k1, k.k2, 0, i)) for i in range(num)]


def bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (in int64) to float32 in [0, 1), as ``jax.random.uniform``
    does: 23 high bits as the mantissa of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform_ref(k: Key, shape: Sequence[int],
                device: "torch.device | str" = "cpu") -> torch.Tensor:
    """``jax.random.uniform(k, shape)`` (float32, [0, 1)) in plain torch."""
    shape = tuple(int(s) for s in shape)
    i = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    y1, y2 = threefry2x32(k.k1, k.k2, i >> 32, i & MASK32)
    return bits_to_unit_float(y1 ^ y2).reshape(shape)
