"""Wavefront spectral path-tracing engine (torch), main-path slice.

Port of ``pathtracing_spectrum_tpu/engine.py`` for the dense, non-hero case
with no textures, no temperature grids and no bounce-ray reorder. The
reference's recursive ``Trace`` (pathtracer.cpp:424-541) unrolls into a
bounce loop over [N] ray planes and [nw, N] spectra::

    radiance   += throughput * emissivity
    throughput *= reflectivity

with the reference's behaviours kept: ``2 * max_depth`` hit iterations and
a sky fall-through for rays still alive after them; Russian roulette from
hit ``max_depth`` on (iteration ``h >= max_depth - 1``), a killed ray
returning the *baked* emissivity; smooth normals, backface flip, the
``p += n * EPS`` offset and the ``2 * EPS`` step back on refraction; dead
rays parked at origin 1e30 with rd = 0.

Per iteration the two kernels run: ``ops/intersect_cuda.intersect_dense``
(closest hit, with the winner's s2/s3) and ``ops/fetch_cuda.fetch_rows``
(the [F', N] attribute planes). Barycentrics come from s2/s3, as on the
JAX package's CPU ``dense`` route, so no geometry rows are fetched.

Randomness: ``rand_override`` ([2*max_depth, 4, N]) is honoured exactly;
otherwise each iteration draws ``torch.rand((4, N))`` from the sample's
``torch.Generator`` (:func:`sample_generator`, seeded from (seed, sample
index) alone). The streams are not JAX's threefry (ROADMAP Queue 1 item 4).

Not in this slice, each raising ``NotImplementedError``: dispersion/hero
modes, textures and temperature grids (ROADMAP Queue 1 item 6), backends
other than "auto"/"dense", bounce-ray reorder and ``chunks > 1`` (item 7),
camera jitter (item 8). Left out for good (item 10): the TPU tuning knobs,
``reorder_period``/``reorder_freeze``, the one-hot fetch route.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .constants import EPS
from .ops import fetch_cuda, intersect_cuda, sampling
from .ops.intersect import pack_tri16
from .ops.shade_pack import layout as shade_layout
from .scene import SceneData

# "auto" backend: dense sweep up to this triangle count (the JAX package's
# engine.DENSE_AUTO_MAX_TRIS); above it the large-scene path is not ported.
DENSE_AUTO_MAX_TRIS = 512

# Shading-table columns the dense non-hero bounce reads, in fetch order.
# At nw = 4 that is F' = 23 + 2*nw = 31 columns.
_COLUMNS = ("uv1", "uv2", "uv3", "face_n", "n1", "n2", "n3", "smoothing",
            "inv_denom", "mat_type", "rr_prob", "roughness",
            "emissivity", "reflectivity")


class TraceResult(NamedTuple):
    radiance: torch.Tensor     # [N, nw]
    rays_traced: torch.Tensor  # [] int64 — rays cast (live rays per iteration)


def resolve_backend(backend: str, n_tris: int) -> str:
    """Map "auto"/"dense" to the dense sweep; raise for the rest."""
    if backend not in ("auto", "dense"):
        raise NotImplementedError(
            f"backend {backend!r} is not ported (ROADMAP Queue 1 item 7 / "
            f"Queue 2 K3a, K3b, K4)")
    if backend == "auto" and n_tris > DENSE_AUTO_MAX_TRIS:
        raise NotImplementedError(
            f"{n_tris} triangles: the large-scene path is not ported "
            f"(ROADMAP Queue 1 item 7); pass backend='dense' to sweep them all")
    return "dense"


def _column_subset(nw: int):
    """(name -> row slice in the fetched subset, source column list)."""
    lay = shade_layout(nw)
    sub, cols = {}, []
    for name in _COLUMNS:
        s = lay[name]
        sub[name] = slice(len(cols), len(cols) + s.stop - s.start)
        cols.extend(range(s.start, s.stop))
    return sub, cols


def _check_slice(scene: SceneData, dispersion, reorder) -> None:
    if dispersion:
        raise NotImplementedError(
            "dispersion/hero spectral modes are not ported "
            "(ROADMAP Queue 1 item 6)")
    if scene.textures.shape[0] > 0 or scene.temp_grids.shape[0] > 0:
        raise NotImplementedError(
            "textures and temperature grids are not ported "
            "(ROADMAP Queue 1 item 6)")
    if reorder not in ("auto", False):
        raise NotImplementedError(
            "bounce-ray reorder is not ported (ROADMAP Queue 1 item 7)")


class _Prepared(NamedTuple):
    tri16: torch.Tensor      # [T, 16] packed intersection table
    shade_sub: torch.Tensor  # [T, F'] fetched column subset
    sub: dict                # name -> row slice of the [F', N] attributes


def _prepare(scene: SceneData, backend: str) -> _Prepared:
    resolve_backend(backend, scene.n_triangles)
    tri16 = pack_tri16(scene.tri_face_n, scene.tri_k1, scene.tri_k2,
                       scene.tri_k3, scene.tri_consts)
    sub, cols = _column_subset(scene.n_waves)
    idx = torch.tensor(cols, dtype=torch.long, device=scene.tri_shade.device)
    shade_sub = scene.tri_shade.index_select(1, idx).contiguous()
    return _Prepared(tri16, shade_sub, sub)


def _primary(prep: _Prepared, ro: torch.Tensor, rd: torch.Tensor):
    """(hit, t, idx, s2, s3, attrs_t) of the primary rays: sample-invariant
    without jitter, so render_samples computes it once per call."""
    hit0 = intersect_cuda.intersect_dense(
        *(ro[:, k].contiguous() for k in range(3)),
        *(rd[:, k].contiguous() for k in range(3)), prep.tri16)
    return hit0 + (fetch_cuda.fetch_rows(hit0[2], prep.shade_sub),)


def sample_generator(seed: int, counter: int,
                     device: "torch.device | str") -> torch.Generator:
    """The variate stream of sample ``counter``: a generator on ``device``
    seeded from (seed, counter) alone, so a sample's variates depend only on
    its index (the role of ``fold_in(key, counter)`` in the JAX package)."""
    g = torch.Generator(device=device)
    g.manual_seed(((int(seed) & 0xFFFFFFFF) << 32)
                  | (int(counter) & 0xFFFFFFFF))
    return g


def trace_radiance(scene: SceneData, ro: torch.Tensor, rd: torch.Tensor,
                   generator: Optional[torch.Generator], max_depth: int,
                   backend: str = "auto",
                   rand_override: Optional[torch.Tensor] = None,
                   dispersion: bool = False, reorder: object = "auto",
                   primary0=None, _prep: Optional[_Prepared] = None
                   ) -> TraceResult:
    """Trace radiance spectra for a batch of rays.

    Args:
      scene: compiled scene (port ``SceneData``) on the rays' device.
      ro, rd: [N, 3] float32 primary rays.
      generator: variate stream of this sample (ignored with
        ``rand_override``).
      max_depth: the reference's trace depth; the loop runs
        ``2*max_depth`` hit iterations (pathtracer.cpp:455).
      backend: "auto" or "dense".
      rand_override: optional [2*max_depth, 4, N] U[0,1) variates, used
        exactly (tests: shared variates with the JAX engine / the oracle).
      primary0: optional (hit, t, idx, s2, s3, attrs_t) for THIS (ro, rd),
        the hoisted primary intersection and fetch (see render_samples).

    Returns TraceResult(radiance [N, nw], rays_traced 0-d int64 tensor).
    """
    _check_slice(scene, dispersion, reorder)
    prep = _prep if _prep is not None else _prepare(scene, backend)
    n = ro.shape[0]
    nw = scene.n_waves
    dev = ro.device
    sub = prep.sub

    def rows(attrs_t, name):
        return attrs_t[sub[name]]

    def row(attrs_t, name):
        return attrs_t[sub[name].start]

    def row3(attrs_t, name):
        s = sub[name].start
        return attrs_t[s], attrs_t[s + 1], attrs_t[s + 2]

    sky = scene.sky[:, None]

    def body(h, state, hit0=None):
        (rox, roy, roz, rdx, rdy, rdz,
         throughput_t, radiance_t, inside, alive, rays_traced) = state
        rays_traced = rays_traced + alive.sum()

        if hit0 is not None:
            hit, t, idx, s2, s3, attrs_t = hit0
        else:
            hit, t, idx, s2, s3 = intersect_cuda.intersect_dense(
                rox, roy, roz, rdx, rdy, rdz, prep.tri16)
            attrs_t = fetch_cuda.fetch_rows(idx, prep.shade_sub)
        hit = hit & alive

        # ---- hit geometry: alpha/beta from the winner's s2/s3 ----
        px, py, pz = rox + t * rdx, roy + t * rdy, roz + t * rdz
        inv_denom = row(attrs_t, "inv_denom")
        alpha = s2 * inv_denom
        beta = s3 * inv_denom
        w0 = 1.0 - alpha - beta

        # ---- shading normal: smooth -> backface flip ----
        fnx, fny, fnz = row3(attrs_t, "face_n")
        n1x, n1y, n1z = row3(attrs_t, "n1")
        n2x, n2y, n2z = row3(attrs_t, "n2")
        n3x, n3y, n3z = row3(attrs_t, "n3")
        smx, smy, smz = sampling.norm3(w0 * n1x + alpha * n2x + beta * n3x,
                                       w0 * n1y + alpha * n2y + beta * n3y,
                                       w0 * n1z + alpha * n2z + beta * n3z)
        smooth = row(attrs_t, "smoothing") > 0.5
        nx = torch.where(smooth, smx, fnx)
        ny = torch.where(smooth, smy, fny)
        nz = torch.where(smooth, smz, fnz)
        backface = (nx * rdx + ny * rdy + nz * rdz) > 0.0
        nx = torch.where(backface, -nx, nx)
        ny = torch.where(backface, -ny, ny)
        nz = torch.where(backface, -nz, nz)
        roughness = row(attrs_t, "roughness")
        pox, poy, poz = px + nx * EPS, py + ny * EPS, pz + nz * EPS

        # ---- randoms ----
        if rand_override is not None:
            rr_rand, u_rand, th_rand, fr_rand = rand_override[h]
        else:
            rr_rand, u_rand, th_rand, fr_rand = torch.rand(
                (4, n), generator=generator, device=dev)

        # ---- Russian roulette (from the max_depth-th hit on) ----
        if h >= max_depth - 1:
            killed = hit & (rr_rand > row(attrs_t, "rr_prob"))
        else:
            killed = torch.zeros_like(hit)

        # miss: sky, die. kill: baked emissivity, die. survive: emissivity,
        # throughput *= reflectivity.
        miss = alive & ~hit
        survive = hit & ~killed
        emis_t = rows(attrs_t, "emissivity")        # [nw, N]
        refl_t = rows(attrs_t, "reflectivity")
        contrib = (miss[None, :] * sky + killed[None, :] * emis_t
                   + survive[None, :] * emis_t)
        radiance_t = radiance_t + throughput_t * contrib
        throughput_t = torch.where(survive[None, :], throughput_t * refl_t,
                                   throughput_t)

        # ---- bounce ----
        mat_i = row(attrs_t, "mat_type").to(torch.int32)
        b = sampling.sample_bounce_soa(mat_i, rdx, rdy, rdz, nx, ny, nz,
                                       roughness, inside, u_rand, th_rand,
                                       fr_rand)
        # dead rays are parked far away with a zero direction: the triangle
        # predicate rejects them (denom == 0)
        back = torch.where(b.refracted, EPS * 2.0, 0.0)
        park = 1e30
        rox = torch.where(survive, pox - nx * back, park)
        roy = torch.where(survive, poy - ny * back, park)
        roz = torch.where(survive, poz - nz * back, park)
        rdx = torch.where(survive, b.dx, 0.0)
        rdy = torch.where(survive, b.dy, 0.0)
        rdz = torch.where(survive, b.dz, 0.0)
        inside = torch.where(survive, b.new_inside, inside)
        return (rox, roy, roz, rdx, rdy, rdz, throughput_t, radiance_t,
                inside, survive, rays_traced)

    f32 = dict(dtype=torch.float32, device=dev)
    state = (*(ro[:, k].contiguous() for k in range(3)),
             *(rd[:, k].contiguous() for k in range(3)),
             torch.ones((nw, n), **f32), torch.zeros((nw, n), **f32),
             torch.zeros(n, dtype=torch.bool, device=dev),
             torch.ones(n, dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.int64, device=dev))
    # bounce 0 is peeled: the caller may supply the hoisted primary hit
    state = body(0, state, hit0=primary0)
    for h in range(1, 2 * max_depth):
        state = body(h, state)
    throughput_t, radiance_t, alive, rays_traced = (state[6], state[7],
                                                    state[9], state[10])

    # depth-cap fall-through: surviving rays see the sky (pathtracer.cpp:536-540)
    radiance_t = radiance_t + alive[None, :] * throughput_t * sky
    return TraceResult(radiance_t.t(), rays_traced)


def render_sample(scene: SceneData, ro, rd, total, samples: int,
                  generator: Optional[torch.Generator], max_depth: int,
                  backend: str = "auto", dispersion: bool = False,
                  reorder: object = "auto"):
    """One progressive sample: ``total += radiance; out = total / samples``
    (RenderFrame, pathtracer.cpp:595-598). ``total`` is not modified.

    Returns (total', samples', out, rays_traced).
    """
    res = trace_radiance(scene, ro, rd, generator, max_depth, backend,
                         dispersion=dispersion, reorder=reorder)
    total = total + res.radiance
    samples = samples + 1
    return total, samples, total / samples, res.rays_traced


def render_samples(scene: SceneData, ro, rd, total, samples: int, seed: int,
                   counter0: int, n_steps: int, max_depth: int,
                   backend: str = "auto", dispersion: bool = False,
                   reorder: object = "auto", jitter_cam=None,
                   chunks: int = 1):
    """``n_steps`` progressive samples; sample ``i`` draws from
    ``sample_generator(seed, counter0 + i)``, the same schedule as repeated
    :func:`render_sample` calls.

    The primary intersection AND its attribute fetch are sample-invariant
    (fixed rays, no randomness before the first hit), so both are computed
    once here and reused by every sample — the same calls, made earlier.

    ``total`` is accumulated IN PLACE (the JAX version donates it) and
    returned. Returns (total, samples', out, rays_traced 0-d int64 tensor).
    """
    if jitter_cam is not None:
        raise NotImplementedError(
            "camera jitter is not ported (ROADMAP Queue 1 item 8)")
    if chunks != 1:
        raise NotImplementedError(
            "chunks > 1 (bounded-width wavefront) is not ported "
            "(ROADMAP Queue 1 item 7)")
    _check_slice(scene, dispersion, reorder)
    prep = _prepare(scene, backend)
    primary0 = _primary(prep, ro, rd)
    rays = torch.zeros((), dtype=torch.int64, device=ro.device)
    for i in range(n_steps):
        gen = sample_generator(seed, counter0 + i, ro.device)
        res = trace_radiance(scene, ro, rd, gen, max_depth, backend,
                             reorder=reorder, primary0=primary0, _prep=prep)
        total.add_(res.radiance)
        rays = rays + res.rays_traced
    samples = samples + n_steps
    return total, samples, total / samples, rays
