"""Bounce-direction sampling for the four surface models (torch).

Port of ``pathtracing_spectrum_tpu/ops/sampling.py::sample_bounce_soa``
(reference ``PathTracer::Trace`` material branches, pathtracer.cpp:466-514),
over [N] component planes, with the same operation order and the
reference's quirks:

* DIFFUSE: ``dir = w*cos(2 pi th)*u + w*sin(2 pi th)*v + sqrt(1-w^2)*n``,
  ``u = cross((1,0,0), n)`` unless ``|n.x| >= 1 - EPS``, then
  ``cross((1,1,1), n)``;
* GLOSSY: the same construction around the mirror direction ``r`` with
  ``w = u * roughness``; the frame's branch tests **n.x** with FLT_EPSILON
  and ``v = cross(u, r)`` is not re-normalised (pathtracer.cpp:484);
* GLASS: Snell + Schlick with nc = 1.0, ng = 1.5 and Schlick power **2**;
  total internal reflection reflects, refraction flips ``inside``. The
  dispersion mode passes per-ray ratios ``eta_inside``/``eta_outside``
  (the hero channel's Cauchy index and its inverse) in place of 1.5 and
  1/1.5; the Schlick ``r0`` keeps 1.5, as in the JAX package.

All four candidates are computed for every ray and selected by type.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..constants import EPS

FLT_EPSILON = 1.1920929e-07
TWO_PI = 2.0 * math.pi


class BounceSampleSoA(NamedTuple):
    dx: torch.Tensor            # [N]
    dy: torch.Tensor
    dz: torch.Tensor
    refracted: torch.Tensor     # [N] bool — glass ray crossed the interface
    new_inside: torch.Tensor    # [N] bool


def norm3(x, y, z):
    """Normalise (x, y, z) with rsqrt; zero vectors stay zero."""
    s = x * x + y * y + z * z
    pos = s > 0
    inv = torch.where(pos, torch.rsqrt(torch.where(pos, s, 1.0)), 0.0)
    return x * inv, y * inv, z * inv


def _cross3(ax, ay, az, bx, by, bz):
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def sample_bounce_soa(mat_type, rdx, rdy, rdz, nx, ny, nz, roughness,
                      inside, u_rand, theta_rand, fresnel_rand,
                      eta_inside=None, eta_outside=None) -> BounceSampleSoA:
    """Bounce direction for every ray.

    Args:
      mat_type: [N] int32 (MaterialType codes).
      rdx..rdz: [N] incoming unit direction.
      nx..nz: [N] shading normal, already front-facing.
      roughness: [N] glossy cone scale.
      inside: [N] bool glass state.
      u_rand, theta_rand, fresnel_rand: [N] U[0,1) variates.
      eta_inside, eta_outside: optional [N] refraction ratios for a ray
        inside and outside the glass (defaults ng/nc = 1.5 and nc/ng).
    """
    ndot = rdx * nx + rdy * ny + rdz * nz
    rx = rdx - 2.0 * ndot * nx
    ry = rdy - 2.0 * ndot * ny
    rz = rdz - 2.0 * ndot * nz

    cos_a = torch.cos(TWO_PI * theta_rand)
    sin_a = torch.sin(TWO_PI * theta_rand)

    # --- DIFFUSE: frame around n (threshold EPS) -------------------------
    x_small = torch.abs(nx) < (1.0 - EPS)
    #   cross((1,0,0), n) = (0, -nz, ny); cross((1,1,1), n) = (nz-ny, nx-nz, ny-nx)
    ux = torch.where(x_small, 0.0, nz - ny)
    uy = torch.where(x_small, -nz, nx - nz)
    uz = torch.where(x_small, ny, ny - nx)
    ux, uy, uz = norm3(ux, uy, uz)
    vx, vy, vz = norm3(*_cross3(ux, uy, uz, nx, ny, nz))
    w = u_rand
    wz = torch.sqrt(torch.clamp_min(1.0 - w * w, 0.0))
    ddx, ddy, ddz = norm3(w * cos_a * ux + w * sin_a * vx + wz * nx,
                          w * cos_a * uy + w * sin_a * vy + wz * ny,
                          w * cos_a * uz + w * sin_a * vz + wz * nz)

    # --- GLOSSY: frame around r, the branch tests n.x --------------------
    gx_small = torch.abs(nx) < (1.0 - FLT_EPSILON)
    gux = torch.where(gx_small, 0.0, rz - ry)
    guy = torch.where(gx_small, -rz, rx - rz)
    guz = torch.where(gx_small, ry, ry - rx)
    gux, guy, guz = norm3(gux, guy, guz)
    gvx, gvy, gvz = _cross3(gux, guy, guz, rx, ry, rz)
    wg = u_rand * roughness
    wgz = torch.sqrt(torch.clamp_min(1.0 - wg * wg, 0.0))
    gdx = wg * cos_a * gux + wg * sin_a * gvx + wgz * rx
    gdy = wg * cos_a * guy + wg * sin_a * gvy + wgz * ry
    gdz = wg * cos_a * guz + wg * sin_a * gvz + wgz * rz

    # --- GLASS ------------------------------------------------------------
    nc, ng = 1.0, 1.5
    eta = torch.where(inside,
                      ng / nc if eta_inside is None else eta_inside,
                      nc / ng if eta_outside is None else eta_outside)
    r0 = ((nc - ng) / (nc + ng)) ** 2
    c = torch.abs(ndot)
    k = 1.0 - eta * eta * (1.0 - c * c)
    one_c = 1.0 - c
    re = r0 + (1.0 - r0) * (one_c * one_c)  # Schlick power 2 (reference parity)
    reflect_glass = (k < 0.0) | (fresnel_rand < re)
    coef = eta * ndot + torch.sqrt(torch.clamp_min(k, 0.0))
    tx, ty, tz = norm3(eta * rdx - coef * nx, eta * rdy - coef * ny,
                       eta * rdz - coef * nz)
    glx = torch.where(reflect_glass, rx, tx)
    gly = torch.where(reflect_glass, ry, ty)
    glz = torch.where(reflect_glass, rz, tz)

    # --- select by material type ------------------------------------------
    is_spec = mat_type == 1
    is_diff = mat_type == 0
    is_glos = mat_type == 2
    is_glass = mat_type == 3
    dx = torch.where(is_spec, rx, torch.where(is_diff, ddx,
                     torch.where(is_glos, gdx, glx)))
    dy = torch.where(is_spec, ry, torch.where(is_diff, ddy,
                     torch.where(is_glos, gdy, gly)))
    dz = torch.where(is_spec, rz, torch.where(is_diff, ddz,
                     torch.where(is_glos, gdz, glz)))
    refracted = is_glass & ~reflect_glass
    new_inside = torch.where(refracted, ~inside, inside)
    return BounceSampleSoA(dx, dy, dz, refracted, new_inside)
