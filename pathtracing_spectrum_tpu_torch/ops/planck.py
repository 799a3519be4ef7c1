"""Planck blackbody spectral emission and emissivity/reflectivity baking.

Port of ``pathtracing_spectrum_tpu/ops/planck.py`` (reference
PathTracing/src/pathtracer.cpp:360-386): the numpy bakes are copied as they
are (scene compilation stays on the host), ``planck_bbp`` and
``planck_bbp_elem`` are torch functions with the same formula, constants and
operation order.

* ``BBP(T, v) = 2e8 * h*c^2*v^3 / (exp(100*h*c*v / (k*T)) - 1)`` with the
  reference's constants; ``v`` in 1/cm, ``T`` in Kelvin.
* ``emissivity = BBP(T + 273.15) * eps`` and
  ``reflectivity = BBP(T + 273.15) * (1 - eps)`` (the Planck
  pre-multiplication of reflectivity is reference parity).
"""

from __future__ import annotations

import numpy as np
import torch

# Constants exactly as written in the reference source (pathtracer.cpp:362-364).
_C = 299792458.0
_K = 1.0 * 138064852e-31
_H = 2.0 * 3.14159265358979323846 * 105457180e-42

CELSIUS_OFFSET = 273.15


def planck_bbp(temperature_k: torch.Tensor,
               wavenumbers: torch.Tensor) -> torch.Tensor:
    """Planck spectral radiance (reference ``PathTracer::BBP``).

    Args:
      temperature_k: absolute temperature(s) in Kelvin, any shape ``S``.
      wavenumbers: wavenumber grid in 1/cm, shape ``[nw]``.

    Returns radiance of shape ``S + [nw]``; 0 where ``T <= 0``.
    """
    t = temperature_k.to(torch.float32)[..., None]
    v = wavenumbers.to(torch.float32)
    num = 2e8 * (_H * _C * _C) * v * v * v
    x = 100.0 * _H * _C * v / _K / torch.where(t > 0.0, t, 1.0)
    val = num / (torch.exp(x) - 1.0)
    return torch.where(t > 0.0, val, 0.0)


def planck_bbp_elem(temperature_k: torch.Tensor,
                    wavenumber: torch.Tensor) -> torch.Tensor:
    """Elementwise ``BBP``: temperature and wavenumber share a shape. Same
    formula and operation order as :func:`planck_bbp`."""
    t = temperature_k.to(torch.float32)
    v = wavenumber.to(torch.float32)
    num = 2e8 * (_H * _C * _C) * v * v * v
    x = 100.0 * _H * _C * v / _K / torch.where(t > 0.0, t, 1.0)
    val = num / (torch.exp(x) - 1.0)
    return torch.where(t > 0.0, val, 0.0)


def planck_bbp_np(temperature_k, wavenumbers) -> np.ndarray:
    """Host (numpy) twin of ``planck_bbp`` for scene baking."""
    t = np.float32(temperature_k) if np.ndim(temperature_k) == 0 else \
        np.asarray(temperature_k, np.float32)
    t = np.asarray(t, np.float32)[..., None]
    v = np.asarray(wavenumbers, np.float32)
    num = np.float32(2e8 * (_H * _C * _C)) * v * v * v
    x = np.float32(100.0 * _H * _C) * v / np.float32(_K) / np.where(t > 0, t, 1)
    with np.errstate(over="ignore"):  # exp overflow -> inf -> val 0, fine
        val = num / (np.exp(x) - 1.0)
    return np.where(t > 0.0, val, 0.0).astype(np.float32)


def bake_emissivity_np(eps_curve, temperature_c, wavenumbers) -> np.ndarray:
    bbp = planck_bbp_np(np.float32(temperature_c) + np.float32(CELSIUS_OFFSET),
                        wavenumbers)
    return (bbp * np.asarray(eps_curve, np.float32)).astype(np.float32)


def bake_reflectivity_np(eps_curve, temperature_c, wavenumbers) -> np.ndarray:
    bbp = planck_bbp_np(np.float32(temperature_c) + np.float32(CELSIUS_OFFSET),
                        wavenumbers)
    return (bbp * (1.0 - np.asarray(eps_curve, np.float32))).astype(np.float32)
