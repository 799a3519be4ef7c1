"""Host-side ``Wave`` compatibility type (a copy of the JAX package's
``ops/wave.py``, numpy only).

In the reference, ``Wave`` (PathTracing/src/wave.{h,cpp}) is a dynamic
per-wavelength float vector with elementwise arithmetic. In the port spectra
are tensors with a trailing wavelength axis, so the device path never uses
this class; it exists for host-side API parity (scene authoring, I/O, tests)
and keeps the reference's size-mismatch-tolerant semantics
(wave.cpp:29-111): binary ops use the min of the two sizes and copy the
excess of the left operand unchanged; ``+=``/``-=`` only touch the
overlapping prefix.
"""

from __future__ import annotations

import numpy as np


class Wave:
    """Dynamic spectrum vector (reference wave.h:6-34)."""

    __slots__ = ("data",)

    def __init__(self, size_or_data=0):
        if isinstance(size_or_data, (int, np.integer)):
            self.data = np.zeros(int(size_or_data), np.float32)
        else:
            self.data = np.asarray(size_or_data, np.float32).copy()

    # -- reference API ------------------------------------------------------
    def size(self) -> int:
        return int(self.data.shape[0])

    def initialize(self, size: int) -> None:
        """``Wave::Initialize`` — reset to zeros of the given size."""
        self.data = np.zeros(int(size), np.float32)

    # -- arithmetic with min-size semantics (wave.cpp:29-111) ---------------
    def _binary(self, other: "Wave", op) -> "Wave":
        res = Wave(self.size())
        n = min(self.size(), other.size())
        res.data[:n] = op(self.data[:n], other.data[:n])
        res.data[n:] = self.data[n:]
        return res

    def __add__(self, other):
        if isinstance(other, Wave):
            return self._binary(other, np.add)
        return NotImplemented

    def __sub__(self, other):
        if isinstance(other, Wave):
            return self._binary(other, np.subtract)
        return NotImplemented

    def __mul__(self, other):
        if isinstance(other, Wave):
            return self._binary(other, np.multiply)
        return Wave(self.data * np.float32(other))

    def __truediv__(self, other):
        return Wave(self.data / np.float32(other))

    def __iadd__(self, other):
        n = min(self.size(), other.size())
        self.data[:n] += other.data[:n]
        return self

    def __isub__(self, other):
        n = min(self.size(), other.size())
        self.data[:n] -= other.data[:n]
        return self

    def __getitem__(self, i):
        return float(self.data[i])

    def __setitem__(self, i, v):
        self.data[i] = v

    def __len__(self):
        return self.size()

    def __repr__(self):
        return f"Wave({self.data.tolist()})"
