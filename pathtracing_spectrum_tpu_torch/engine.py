"""Wavefront spectral path-tracing engine (torch).

Port of ``pathtracing_spectrum_tpu/engine.py``, every spectral mode, with
normal and roughness maps and temperature grids, on every intersection
backend. The reference's recursive ``Trace`` (pathtracer.cpp:424-541)
unrolls into a bounce loop over [N] ray planes and [nw, N] spectra::

    radiance   += throughput * emissivity
    throughput *= reflectivity

with the reference's behaviours kept: ``2 * max_depth`` hit iterations and
a sky fall-through for rays still alive after them; Russian roulette from
hit ``max_depth`` on (iteration ``h >= max_depth - 1``), a killed ray
returning the *baked* emissivity; smooth normals, backface flip, the
tangent-space normal map with the ``nt.z < 0 -> 0`` clamp, the roughness
map over scalar roughness, the per-hit temperature-grid re-bake through
the Planck curve (pathtracer.cpp:436-453, 520-528); the ``p += n * EPS``
offset and the ``2 * EPS`` step back on refraction; dead rays parked at
origin 1e30 with rd = 0.

Spectral modes (``dispersion``), as in the JAX package: ``False`` keeps
[nw, N] spectra; ``"hero"`` carries one hero channel per ray (throughput
``nw``, an unbiased estimator of the same image) with the reference's
glass; ``True`` adds Cauchy glass, refracting with the hero channel's
index ``ior + B / lambda_um^2``. The hero channel's baked spectra (and its
eps and index when needed) come from a flat ``[T*nw, C]`` table through
K2 at every nw: the JAX package's other route, a one-hot select of the
fetched [nw, N] rows below nw = 128, reads the same entries and is not
ported. K2 returns zeros for a negative index, so a miss's flat index
never wraps.

Per iteration two kernels run: a closest hit (with the winner's s2/s3)
and ``ops/fetch_cuda.fetch_rows`` (the [F', N] attribute planes of the
column subset the configuration reads, :func:`_column_subset`).
Barycentrics come from s2/s3, as on the JAX package's ``dense`` and
``hier`` routes, so no geometry rows are fetched. :func:`make_intersector`
maps the backend names to the closest-hit kernels:

- ``"dense"``, ``"dense_pallas"``: K1, ``ops/intersect_cuda.intersect_dense``;
- ``"hier"``, ``"shortlist"``, ``"worklist"``, ``"bvh"``: K3,
  ``ops/intersect_hier_cuda.intersect_bvh`` through the scene's flat BVH;
- ``"cluster"``: K4, ``ops/intersect_cluster_cuda.intersect_cluster``.

On CPU tensors each runs its plain version. ``"auto"`` resolves by device
and size as the JAX package does on a TPU and on the CPU
(:func:`resolve_backend`). The bounce-ray reorder (``reorder.py``) sorts
the six ray planes before the intersection and unsorts its results, from
the first sorted iteration of ``reorder.reorder_from_policy`` on.

Randomness is ``jax.random``'s key schedule, bit for bit (``ops/rng.py``):
sample ``i`` of :func:`render_samples` traces under ``fold_in(base_key,
counter0 + i)``, iteration ``h`` draws ``uniform(fold_in(key, h), (4, N))``
and the hero channel ``uniform(fold_in(key, 0x0D15), (N,))``; the draws run
in the threefry kernel (``ops/rng_cuda.py``). ``rand_override``
([2*max_depth, 4, N]) replaces the per-iteration draws exactly.
:func:`render_samples` also runs the frame as ``chunks`` sub-wavefronts
and regenerates jittered primary rays per sample (``jitter_cam``), under
the JAX package's key folds.

Left out for good (ROADMAP Queue 1 item 10): the
TPU tuning knobs (``sweep_policy``, the shortlist/worklist split by SMEM
budget), ``reorder_period``/``reorder_freeze``, the material-keyed sort,
the one-hot fetch and hero-select routes.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import torch

from . import reorder as reorder_mod
from .constants import BIG, EPS
from .device import DEFAULT_DEVICE, resolve_device
from .models.camera import jittered_dirs
from .ops import (fetch_cuda, intersect_cluster_cuda, intersect_cuda,
                  intersect_hier_cuda, planck, rng, rng_cuda, sampling)
from .ops.intersect import pack_tri16
from .ops.shade_pack import layout as shade_layout
from .ops.texturing import sample_nearest_wh
from .scene import SceneData

# "auto" backend on CUDA: the dense sweep up to this triangle count, the
# hierarchical kernel above (the JAX package's engine.DENSE_AUTO_MAX_TRIS,
# its TPU threshold).
DENSE_AUTO_MAX_TRIS = 512
# "auto" on the CPU: the dense sweep up to this count, the BVH walk above
# (the JAX package's CPU threshold, engine.py:189-190).
DENSE_AUTO_MAX_TRIS_CPU = 8192

# backend name -> closest-hit route
_ROUTES = {"dense": "dense", "dense_pallas": "dense",
           "hier": "bvh", "shortlist": "bvh", "worklist": "bvh",
           "bvh": "bvh", "cluster": "cluster"}

# fold_in data of the hero-channel draw (engine.py:564 of the JAX package),
# of chunk c's key (CHUNK_FOLD + c, :1041) and of the jitter key (:1063)
HERO_FOLD = 0x0D15
CHUNK_FOLD = 0xC40000
JITTER_FOLD = 0xC0FFEE


class TraceResult(NamedTuple):
    radiance: torch.Tensor     # [N, nw]
    rays_traced: torch.Tensor  # [] int64 — rays cast (live rays per iteration)


def resolve_backend(backend: str, n_tris: int,
                    device: "torch.device | str" = DEFAULT_DEVICE) -> str:
    """Resolve ``"auto"`` for a scene of ``n_tris`` triangles on
    ``device`` (the card unless the caller asks for the CPU), as the JAX
    package does on a TPU (the CUDA thresholds) and on the CPU: ``"dense"``
    up to 512 triangles and ``"hier"`` above on CUDA, ``"dense"`` up to
    8,192 and ``"bvh"`` above on the CPU. Other names pass through; an
    unknown one raises ``ValueError``."""
    device = resolve_device(device)
    if backend == "auto":
        if device.type == "cuda":
            return "dense" if n_tris <= DENSE_AUTO_MAX_TRIS else "hier"
        return "dense" if n_tris <= DENSE_AUTO_MAX_TRIS_CPU else "bvh"
    if backend not in _ROUTES:
        raise ValueError(f"unknown backend {backend!r}; expected 'auto' or "
                         f"one of {sorted(_ROUTES)}")
    return backend


def make_intersector(scene: SceneData, backend: str
                     ) -> "tuple[Callable, str]":
    """Resolve the backend and return (``intersect(ox..dz) -> (hit, t,
    idx, s2, s3)`` over [N] planes, the resolved name). The closure holds
    the packed [T, 16] table and the kernel's scene arrays (for K3 the node
    records, for K4 the cluster and group boxes, packed here once per
    scene); it serves the bounce loop and the primary-hit hoist alike."""
    backend = resolve_backend(backend, scene.n_triangles,
                              scene.tri_shade.device)
    tri16 = pack_tri16(scene.tri_face_n, scene.tri_k1, scene.tri_k2,
                       scene.tri_k3, scene.tri_consts)
    route = _ROUTES[backend]
    if route == "dense":
        def intersect(*planes):
            return intersect_cuda.intersect_dense(*planes, tri16)
    elif route == "bvh":
        bvh = intersect_hier_cuda.pack_bvh(
            scene.bvh_node_min, scene.bvh_node_max, scene.bvh_node_skip,
            scene.bvh_node_first, scene.bvh_node_count)

        def intersect(*planes):
            return intersect_hier_cuda.intersect_bvh(*planes, tri16, bvh)
    else:
        clusters = intersect_cluster_cuda.pack_clusters(scene.cluster_aabbs)

        def intersect(*planes):
            return intersect_cluster_cuda.intersect_cluster(
                *planes, tri16, clusters)
    return intersect, backend


def _texture_flags(scene: SceneData):
    """(normal maps bound, roughness maps bound, temperature grids bound):
    each kind that no element binds is skipped statically."""
    has_tex = scene.textures.shape[0] > 0
    return (has_tex and scene.normal_tex_any.shape[0] > 0,
            has_tex and scene.roughness_tex_any.shape[0] > 0,
            scene.temp_grids.shape[0] > 0)


def _column_subset(nw: int, has_ntex: bool, has_rtex: bool, has_grids: bool,
                   want_ior: bool, hero: bool = False):
    """The shading-table columns one configuration reads (the JAX
    ``_column_subset`` without the dense-Pallas geometry rows: the port's
    barycentrics always come from s2/s3). With ``hero`` the spectral
    curves come from the flat hero table instead. Returns (name -> row
    slice in the fetched subset, source column list)."""
    lay = shade_layout(nw)
    names = ["uv1", "uv2", "uv3", "face_n", "n1", "n2", "n3", "smoothing",
             "inv_denom", "mat_type", "rr_prob", "roughness"]
    if not hero:
        names += ["emissivity", "reflectivity"]
    if has_ntex:
        names += ["tangent", "bitangent", "normal_tex", "normal_tex_wh"]
    if has_rtex:
        names += ["roughness_tex", "roughness_tex_wh"]
    if has_grids:
        names += ([] if hero else ["eps_curve"]) + ["temp_grid",
                                                    "temp_grid_wh"]
    if want_ior and not hero:
        names.append("ior_curve")
    sub, cols = {}, []
    for name in names:
        s = lay[name]
        sub[name] = slice(len(cols), len(cols) + s.stop - s.start)
        cols.extend(range(s.start, s.stop))
    return sub, cols


def _check_reorder(reorder) -> None:
    if reorder not in ("auto", True, False):
        raise ValueError(f"reorder={reorder!r}: expected 'auto', True or "
                         "False")


class _Prepared(NamedTuple):
    intersect: Callable      # (ox..dz) -> (hit, t, idx, s2, s3)
    backend: str             # the resolved backend
    shade_sub: torch.Tensor  # [T, F'] fetched column subset
    sub: dict                # name -> row slice of the [F', N] attributes
    frame: Optional[tuple]   # (smin, inv_ext) of the reorder key, or None
    flags: tuple             # _texture_flags(scene)
    hero: bool               # hero estimator (dispersion "hero" or True)
    cauchy: bool             # Cauchy glass (dispersion True)
    hero_table: Optional[torch.Tensor]  # [T*nw, C] emis, refl[, eps][, ior]


def _prepare(scene: SceneData, backend: str, reorder="auto",
             dispersion=False) -> _Prepared:
    """Resolve the backend, pack the tables, and decide the reorder: on
    with ``True``, off with ``False``; with ``"auto"``, on for the K3/K4
    routes on CUDA at ``reorder.REORDER_AUTO_MIN_TRIS`` triangles or more
    (the JAX package turns it on for its TPU kernels the same way)."""
    intersect, backend = make_intersector(scene, backend)
    nw = scene.n_waves
    flags = _texture_flags(scene)
    hero = bool(dispersion) and nw > 0
    cauchy = dispersion is True and nw > 0
    sub, cols = _column_subset(nw, *flags, cauchy, hero)
    dev = scene.tri_shade.device
    idx = torch.tensor(cols, dtype=torch.long, device=dev)
    shade_sub = scene.tri_shade.index_select(1, idx).contiguous()
    hero_table = None
    if hero:
        lay = shade_layout(nw)
        curves = ["emissivity", "reflectivity"] + (
            ["eps_curve"] if flags[2] else []) + (
            ["ior_curve"] if cauchy else [])
        hero_table = torch.stack(
            [scene.tri_shade[:, lay[c]].reshape(-1) for c in curves],
            dim=1).contiguous()
    do_reorder = (reorder is True
                  or (reorder == "auto" and dev.type == "cuda"
                      and _ROUTES[backend] != "dense"
                      and scene.n_triangles
                      >= reorder_mod.REORDER_AUTO_MIN_TRIS))
    frame = (reorder_mod.scene_bounds(scene.cluster_aabbs) if do_reorder
             else None)
    return _Prepared(intersect, backend, shade_sub, sub, frame, flags, hero,
                     cauchy, hero_table)


def _primary(prep: _Prepared, ro: torch.Tensor, rd: torch.Tensor):
    """(hit, t, idx, s2, s3, attrs_t) of the primary rays: sample-invariant
    without jitter, so render_samples computes it once per call."""
    hit0 = prep.intersect(*(ro[:, k].contiguous() for k in range(3)),
                          *(rd[:, k].contiguous() for k in range(3)))
    return hit0 + (fetch_cuda.fetch_rows(hit0[2], prep.shade_sub),)


def _sorted_intersect(prep: _Prepared, planes, alive):
    """The intersection with the bounce-ray reorder around it: sort the six
    ray planes by ``reorder.sort_key``, intersect, unsort (t, s2, s3, idx)
    and derive ``hit = t < BIG``, as every kernel does (engine.py:610-644
    of the JAX package). Any permutation gives the same result."""
    smin, inv_ext = prep.frame
    key = reorder_mod.sort_key(*planes, alive, smin, inv_ext)
    perm, inv = reorder_mod.permutation(key)
    _, t, idx, s2, s3 = prep.intersect(*(p[perm] for p in planes))
    t = t[inv]
    return t < BIG, t, idx[inv], s2[inv], s3[inv]


def _draw(k: rng.Key, rows: tuple, n: int, dev, frame=None) -> torch.Tensor:
    """``uniform(k, (*rows, n))``; with ``frame=(offset, width)`` columns
    ``offset..offset+n`` of ``uniform(k, (*rows, width))``."""
    if frame is None:
        return rng_cuda.uniform(k, (*rows, n), dev)
    offset, width = frame
    return rng_cuda.uniform(k, (*rows, width),
                            dev)[..., offset:offset + n].contiguous()


def trace_radiance(scene: SceneData, ro: torch.Tensor, rd: torch.Tensor,
                   key: Optional[rng.Key], max_depth: int,
                   backend: str = "auto",
                   rand_override: Optional[torch.Tensor] = None,
                   dispersion=False, reorder: object = "auto",
                   primary0=None, _prep: Optional[_Prepared] = None,
                   frame: Optional[tuple] = None) -> TraceResult:
    """Trace radiance spectra for a batch of rays.

    Args:
      scene: compiled scene (port ``SceneData``) on the rays' device.
      ro, rd: [N, 3] float32 primary rays.
      key: this sample's ``ops/rng.Key`` (the JAX package's PRNG key).
        Without ``rand_override`` iteration ``h`` draws
        ``uniform(fold_in(key, h), (4, N))``; the hero modes draw the hero
        channel from ``fold_in(key, 0x0D15)`` either way.
      max_depth: the reference's trace depth; the loop runs
        ``2*max_depth`` hit iterations (pathtracer.cpp:455).
      backend: "auto" or a backend name (see :func:`resolve_backend`).
      rand_override: optional [2*max_depth, 4, N] U[0,1) variates, used
        exactly (tests: shared variates with the JAX engine / the oracle).
      dispersion: False, "hero" or True (see the module docstring).
      reorder: "auto", True or False: sort the bounce rays around the
        intersection (see :func:`_prepare`); result-exact either way.
      primary0: optional (hit, t, idx, s2, s3, attrs_t) for THIS (ro, rd),
        the hoisted primary intersection and fetch (see render_samples).
      frame: optional (offset, width): the rays are columns
        ``offset..offset+N`` of a ``width``-ray frame, and each draw is the
        frame's draw cut to those columns, so a tile traces as the whole
        frame would trace it (``parallel/tiling.py`` without the device
        fold).

    Returns TraceResult(radiance [N, nw], rays_traced 0-d int64 tensor).
    """
    _check_reorder(reorder)
    prep = (_prep if _prep is not None
            else _prepare(scene, backend, reorder, dispersion))
    has_ntex, has_rtex, has_grids = prep.flags
    if key is None and (rand_override is None or prep.hero):
        raise ValueError("trace_radiance needs a key (only a non-hero trace "
                         "with rand_override runs without one)")
    first_sorted = reorder_mod.reorder_from_policy(scene.n_triangles,
                                                   max_depth)
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

    def sample_map(table, attrs_t, id_name, uvu, uvv):
        tex_id = row(attrs_t, id_name).to(torch.int32)
        wh = sub[id_name + "_wh"].start
        return tex_id, sample_nearest_wh(table, tex_id, attrs_t[wh],
                                         attrs_t[wh + 1], uvu, uvv)

    if prep.hero:
        hero_u = _draw(rng.fold_in(key, HERO_FOLD), (), n, dev, frame)
        hero = torch.clamp_max((hero_u * nw).to(torch.int32), nw - 1)
        hero_l = hero.long()
        channels = torch.arange(nw, dtype=torch.int32, device=dev)
        hero_onehot_t = (channels[:, None]
                         == hero[None, :]).to(torch.float32)    # [nw, N]
        sky = scene.sky[hero_l]                                 # [N]
        wn_hero = scene.wavenumbers[hero_l] if has_grids else None
    else:
        sky = scene.sky[:, None]                                # [nw, 1]

    def body(h, state, hit0=None):
        (rox, roy, roz, rdx, rdy, rdz,
         throughput_t, radiance_t, inside, alive, rays_traced) = state
        rays_traced = rays_traced + alive.sum()

        planes = (rox, roy, roz, rdx, rdy, rdz)
        if hit0 is not None:
            hit, t, idx, s2, s3, attrs_t = hit0
        else:
            if prep.frame is not None and h >= first_sorted:
                hit, t, idx, s2, s3 = _sorted_intersect(prep, planes, alive)
            else:
                hit, t, idx, s2, s3 = prep.intersect(*planes)
            attrs_t = fetch_cuda.fetch_rows(idx, prep.shade_sub)
        hit = hit & alive

        # ---- hit geometry: alpha/beta from the winner's s2/s3 ----
        px, py, pz = rox + t * rdx, roy + t * rdy, roz + t * rdz
        inv_denom = row(attrs_t, "inv_denom")
        alpha = s2 * inv_denom
        beta = s3 * inv_denom
        w0 = 1.0 - alpha - beta
        if has_ntex or has_rtex or has_grids:
            s = sub["uv1"].start
            uvu = (w0 * attrs_t[s] + alpha * attrs_t[s + 2]
                   + beta * attrs_t[s + 4])
            uvv = (w0 * attrs_t[s + 1] + alpha * attrs_t[s + 3]
                   + beta * attrs_t[s + 5])

        # ---- shading normal: smooth -> backface flip -> normal map ----
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
        if has_ntex:
            ntex, tex = sample_map(scene.textures, attrs_t, "normal_tex",
                                   uvu, uvv)
            ntx, nty, ntz = (tex[:, 0] * 2.0 - 1.0, tex[:, 1] * 2.0 - 1.0,
                             tex[:, 2] * 2.0 - 1.0)
            ntz = torch.where(ntz < 0.0, 0.0, ntz)
            ntx, nty, ntz = sampling.norm3(ntx, nty, ntz)
            tax, tay, taz = row3(attrs_t, "tangent")
            bx, by, bz = row3(attrs_t, "bitangent")
            mnx, mny, mnz = sampling.norm3(tax * ntx + bx * nty + nx * ntz,
                                           tay * ntx + by * nty + ny * ntz,
                                           taz * ntx + bz * nty + nz * ntz)
            use_map = ntex >= 0
            nx = torch.where(use_map, mnx, nx)
            ny = torch.where(use_map, mny, ny)
            nz = torch.where(use_map, mnz, nz)
        if has_rtex:
            rtex, rough_tex = sample_map(scene.textures, attrs_t,
                                         "roughness_tex", uvu, uvv)
            roughness = torch.where(rtex >= 0, rough_tex[:, 0], roughness)

        pox, poy, poz = px + nx * EPS, py + ny * EPS, pz + nz * EPS

        # ---- randoms ----
        if rand_override is not None:
            rr_rand, u_rand, th_rand, fr_rand = rand_override[h]
        else:
            rr_rand, u_rand, th_rand, fr_rand = _draw(
                rng.fold_in(key, h), (4,), n, dev, frame)

        # ---- Russian roulette (from the max_depth-th hit on) ----
        if h >= max_depth - 1:
            killed = hit & (rr_rand > row(attrs_t, "rr_prob"))
        else:
            killed = torch.zeros_like(hit)

        # ---- emissivity / reflectivity (+ temperature-grid re-bake) ----
        # miss: sky, die. kill: BAKED emissivity, die. survive: effective
        # emissivity, throughput *= effective reflectivity.
        miss = alive & ~hit
        survive = hit & ~killed
        if has_grids:
            grid, temp = sample_map(scene.temp_grids, attrs_t, "temp_grid",
                                    uvu, uvv)
        if prep.hero:
            # one flat (triangle, hero channel) row per ray through K2
            curves = fetch_cuda.fetch_rows(idx * nw + hero, prep.hero_table)
            emis_b, refl_b = curves[0], curves[1]
            if has_grids:
                bbp = planck.planck_bbp_elem(temp + planck.CELSIUS_OFFSET,
                                             wn_hero)
                eps = curves[2]
        else:
            emis_b = rows(attrs_t, "emissivity")        # [nw, N]
            refl_b = rows(attrs_t, "reflectivity")
            if has_grids:
                bbp = planck.planck_bbp(temp + planck.CELSIUS_OFFSET,
                                        scene.wavenumbers).t()  # [nw, N]
                eps = rows(attrs_t, "eps_curve")

        def lanes(mask):   # a per-ray mask over the spectral state's shape
            return mask if prep.hero else mask[None, :]

        if has_grids:
            hg = lanes(grid >= 0)
            emis_eff = torch.where(hg, bbp * eps, emis_b)
            refl_eff = torch.where(hg, bbp * (1.0 - eps), refl_b)
        else:
            emis_eff, refl_eff = emis_b, refl_b
        contrib = (lanes(miss) * sky + lanes(killed) * emis_b
                   + lanes(survive) * emis_eff)
        radiance_t = radiance_t + throughput_t * contrib
        throughput_t = torch.where(lanes(survive), throughput_t * refl_eff,
                                   throughput_t)

        # ---- bounce ----
        eta = {}
        if prep.cauchy:
            ior = torch.clamp_min(curves[-1], 1.0 + 1e-6)
            eta = dict(eta_inside=ior, eta_outside=1.0 / ior)
        mat_i = row(attrs_t, "mat_type").to(torch.int32)
        b = sampling.sample_bounce_soa(mat_i, rdx, rdy, rdz, nx, ny, nz,
                                       roughness, inside, u_rand, th_rand,
                                       fr_rand, **eta)
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
    if prep.hero:
        # E[nw * onehot(hero)] = 1 per channel: one scalar per ray
        throughput0 = torch.full((n,), float(nw), **f32)
        radiance0 = torch.zeros(n, **f32)
    else:
        throughput0 = torch.ones((nw, n), **f32)
        radiance0 = torch.zeros((nw, n), **f32)
    state = (*(ro[:, k].contiguous() for k in range(3)),
             *(rd[:, k].contiguous() for k in range(3)),
             throughput0, radiance0,
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
    if prep.hero:
        radiance_t = hero_onehot_t * (radiance_t + alive * throughput_t * sky)
    else:
        radiance_t = radiance_t + alive[None, :] * throughput_t * sky
    return TraceResult(radiance_t.t(), rays_traced)


def render_sample(scene: SceneData, ro, rd, total, samples: int,
                  key: rng.Key, max_depth: int, backend: str = "auto",
                  dispersion=False, reorder: object = "auto"):
    """One progressive sample under ``key``: ``total += radiance; out =
    total / samples`` (RenderFrame, pathtracer.cpp:595-598). ``total`` is
    not modified.

    Returns (total', samples', out, rays_traced).
    """
    res = trace_radiance(scene, ro, rd, key, max_depth, backend,
                         dispersion=dispersion, reorder=reorder)
    total = total + res.radiance
    samples = samples + 1
    return total, samples, total / samples, res.rays_traced


def render_samples(scene: SceneData, ro, rd, total, samples: int,
                   base_key: rng.Key, counter0: int, n_steps: int,
                   max_depth: int, backend: str = "auto", dispersion=False,
                   reorder: object = "auto", jitter_cam=None,
                   chunks: int = 1, fold_device: Optional[int] = None,
                   frame: Optional[tuple] = None):
    """``n_steps`` progressive samples; sample ``i`` traces under
    ``k_i = rng.fold_in(base_key, counter0 + i)``, the JAX package's
    schedule and that of repeated :func:`render_sample` calls.

    Without ``jitter_cam`` the primary intersection AND its attribute fetch
    are sample-invariant (fixed rays, no randomness before the first hit),
    so both are computed once here, on the whole frame, and reused by every
    sample — the same calls, made earlier.

    ``chunks > 1`` traces the frame as ``chunks`` sequential
    sub-wavefronts of ``N / chunks`` rays (JAX ``engine.py:1002-1056``):
    chunk ``c`` traces under ``fold_in(k_i, 0xC40000 + c)`` with its rows
    of the hoisted primary hit and its columns of the hoisted attributes,
    and the bounce-ray reorder sorts within the chunk. The per-pixel
    arithmetic does not depend on the width, so only the variate stream
    differs from ``chunks=1``.

    ``jitter_cam`` (``models/camera.JitterCam``, rays in the same order as
    ``ro``) regenerates the primary directions of sample ``i`` from
    ``kx, ky = split(fold_in(k_i, 0xC0FFEE))``, two ``[N]`` uniform draws
    (JAX ``engine.py:1057-1070``); the primary hoist is off, since the
    rays differ per sample. Chunks and jitter together are refused, as in
    the JAX package.

    ``fold_device`` (a mesh index, ``parallel/tiling.py``) folds into
    every sample's key after the sample fold, ``k_i = fold_in(fold_in(
    base_key, counter0 + i), fold_device)``, before the chunk and jitter
    folds (JAX ``parallel/tiling.py:137-146``). ``frame=(offset, width)``
    cuts every draw, the jitter offsets' too, from a ``width``-ray frame's
    (see :func:`trace_radiance`); not with chunks.

    ``total`` is accumulated IN PLACE (the JAX version donates it), one
    chunk's rows at a time, and returned. Returns (total, samples', out,
    rays_traced): ``rays_traced`` is a 0-d int64 tensor where the JAX
    package's is int32, so a long 4K run cannot wrap it.
    """
    n = ro.shape[0]
    if chunks > 1:
        if jitter_cam is not None:
            raise ValueError("chunks > 1 does not support jitter_cam yet")
        if n % chunks:
            raise ValueError(f"chunks={chunks} must divide the ray count {n}")
        if frame is not None:
            raise ValueError("chunks > 1 does not support frame")
    _check_reorder(reorder)
    dev = ro.device
    prep = _prepare(scene, backend, reorder, dispersion)
    primary0 = _primary(prep, ro, rd) if jitter_cam is None else None
    trace = functools.partial(trace_radiance, scene, max_depth=max_depth,
                              backend=backend, dispersion=dispersion,
                              reorder=reorder, _prep=prep, frame=frame)

    def sample_key(i):
        k = rng.fold_in(base_key, counter0 + i)
        return k if fold_device is None else rng.fold_in(k, fold_device)

    rays = torch.zeros((), dtype=torch.int64, device=dev)
    if chunks > 1:
        # each chunk's rows of the hoisted hit and columns of the hoisted
        # [F', N] attributes, cut once for every sample
        nc = n // chunks
        parts = []
        for c in range(chunks):
            s = slice(c * nc, (c + 1) * nc)
            parts.append((s, tuple(p[s] for p in primary0[:5])
                          + (primary0[5][:, s].contiguous(),)))
        del primary0
        for i in range(n_steps):
            k = sample_key(i)
            for c, (s, prim) in enumerate(parts):
                res = trace(ro[s], rd[s], rng.fold_in(k, CHUNK_FOLD + c),
                            primary0=prim)
                total[s].add_(res.radiance)
                rays = rays + res.rays_traced
    else:
        for i in range(n_steps):
            k = sample_key(i)
            rd_i = rd
            if jitter_cam is not None:
                kx, ky = rng.split(rng.fold_in(k, JITTER_FOLD))
                nj = jitter_cam.px.shape[0]
                rd_i = jittered_dirs(jitter_cam, _draw(kx, (), nj, dev, frame),
                                     _draw(ky, (), nj, dev, frame))
            res = trace(ro, rd_i, k, primary0=primary0)
            total.add_(res.radiance)
            rays = rays + res.rays_traced
    samples = samples + n_steps
    return total, samples, total / samples, rays
