"""Pixel-tile sharding and spp-allreduce across a device mesh (port of
``pathtracing_spectrum_tpu/parallel/tiling.py``).

* ``TileSharding``: the frame's flat ray axis, padded with zero rays to a
  multiple of the mesh size, is cut into one equal tile per device; each
  device traces and accumulates its own tile. ``gather`` puts the tiles
  together on the mesh's first device (across processes, an
  ``all_gather`` of the equal tiles), without the padding.
* ``SppAllreduce``: every device renders the whole frame under its own key
  fold; the radiance is summed in device order on the mesh's first device
  and, across processes, by an ``all_reduce``, so one step adds
  ``mesh.size`` samples.

Both run the port's one-device engine on each device, the kernels at each
tile's shape. One host thread issues every device's work, each tensor on
its tile's device.

The key schedule is the JAX package's. Sample ``i`` of a tile or device
``dev`` traces under ``fold_in(fold_in(base_key, counter0 + i), dev)``,
then the chunk fold ``0xC40000 + c`` and the jitter fold ``0xC0FFEE``
(``engine.render_samples(fold_device=dev)``). ``TileSharding`` folds the
device in only where the JAX package runs the engine inside ``shard_map``
(:func:`device_fold`); elsewhere JAX partitions the whole-frame
computation, and each tile here takes its columns of the frame's draws
(``engine.render_samples(frame=...)``), which makes it the unsharded
render of the padded frame.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import engine
from ..ops import rng
from .mesh import Mesh, make_mesh

# Backends that the JAX package runs as Pallas kernels, which XLA cannot
# partition: it runs them per tile inside shard_map, with the device fold
# (JAX tiling.py:42-48). On CUDA every backend is a hand-written kernel,
# K1 the counterpart of "dense_pallas", so every backend folds there.
_PALLAS_BACKENDS = ("dense_pallas", "cluster", "shortlist", "worklist",
                    "hier")


def device_fold(backend: str, device: "torch.device | str",
                chunks: int = 1) -> bool:
    """Whether ``TileSharding`` folds each device's mesh index into its
    keys, for the resolved ``backend`` on ``device``: on CUDA always; on
    the CPU, as the JAX package does there, for its Pallas backends and
    for ``chunks > 1`` (both run inside ``shard_map``)."""
    return (torch.device(device).type == "cuda"
            or backend in _PALLAS_BACKENDS or chunks > 1)


def _all_reduce(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the processes of ``mesh`` (``t`` itself when
    no process group is up)."""
    if mesh.distributed:
        dist.all_reduce(t)
    return t


def _sum_devices(mesh: Mesh, parts: List[torch.Tensor]) -> torch.Tensor:
    """The parts summed in device order on the mesh's first device, then
    over the processes."""
    first = mesh.devices[0]
    acc = parts[0].to(first)
    for p in parts[1:]:
        acc = acc + p.to(first)
    return _all_reduce(mesh, acc)


def _scene_on(scene_data, device):
    """A copy of a compiled scene on ``device``."""
    return type(scene_data)(*(t.to(device) for t in scene_data))


class _Strategy:
    """What both strategies share: the mesh, the scene copies per device
    (kept for the last scene seen), rays and scene placement."""

    name = ""
    supports_jitter_cam = False
    supports_chunks = False

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_devices = self.mesh.size
        self._scene_of = None
        self._scenes = None

    def shard_scene(self, scene_data) -> list:
        """The scene on each local device (copied once per scene)."""
        if scene_data is not self._scene_of:
            self._scenes = [_scene_on(scene_data, d)
                            for d in self.mesh.devices]
            self._scene_of = scene_data
        return self._scenes


class TileSharding(_Strategy):
    """Shard the flat pixel axis over a 1-D mesh."""

    name = "tiles"
    supports_jitter_cam = True  # batched jitter: px/py shard like rays
    supports_chunks = True      # chunks x tiles compose (render_samples)

    def __init__(self, mesh: Optional[Mesh] = None):
        super().__init__(mesh)
        self._true_n = None

    def folds_device(self, backend: str, chunks: int = 1) -> bool:
        """:func:`device_fold` on this mesh's devices."""
        return device_fold(backend, self.mesh.devices[0], chunks)

    def _tiles(self, a: torch.Tensor) -> list:
        """This process's tiles of ``a`` (padded with zero rows to a
        multiple of the mesh size), each on its device."""
        n = a.shape[0]
        pad = (-n) % self.n_devices
        if pad:
            a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        nloc = a.shape[0] // self.n_devices
        return [a[g * nloc:(g + 1) * nloc].to(d).contiguous()
                for d, g in self._local()]

    def _local(self):
        return [(d, self.mesh.global_index(i))
                for i, d in enumerate(self.mesh.devices)]

    def shard_rays(self, ro, rd):
        """Per-device tiles of [N, 3] rays; the padding rays have
        ``ro = rd = 0`` (they miss everything, and ``gather`` drops
        them)."""
        self._true_n = ro.shape[0]
        return self._tiles(ro), self._tiles(rd)

    def shard_jitter_cam(self, jc):
        """Per-device cameras: the pixel-coordinate planes cut like the
        rays, the camera scalars copied. Padding slots ray through pixel
        (0, 0); their results land in padded rows that ``gather`` drops."""
        pxs, pys = self._tiles(jc.px), self._tiles(jc.py)
        return [jc._replace(px=px, py=py,
                            **{f: getattr(jc, f).to(d) for f in
                               ("pos", "top_left", "right", "up", "dx",
                                "dy")})
                for (d, _), px, py in zip(self._local(), pxs, pys)]

    def zeros_accumulator(self, n, nw):
        pad_n = n + ((-n) % self.n_devices)
        nloc = pad_n // self.n_devices
        return [torch.zeros((nloc, nw), dtype=torch.float32, device=d)
                for d in self.mesh.devices]

    def shard_accumulator(self, total):
        return self._tiles(total)

    def render_sample(self, scene_data, ro, rd, total, samples, key,
                      max_depth, backend="auto", dispersion=False):
        """``engine.render_sample`` over the tiles (``total`` is not
        modified). With the device fold, tile ``dev`` traces under
        ``fold_in(fold_in(key, 0), dev)``, JAX's one-step ``shard_map``
        schedule; without it, under ``key`` with the frame's draws."""
        scenes = self.shard_scene(scene_data)
        fold = self.folds_device(engine.resolve_backend(
            backend, scene_data.n_triangles, self.mesh.devices[0]))
        nloc = ro[0].shape[0]
        new_total, rays = [], []
        for (_, g), sc, o, r, t in zip(self._local(), scenes, ro, rd, total):
            res = engine.trace_radiance(
                sc, o, r, rng.fold_in(rng.fold_in(key, 0), g) if fold else key,
                max_depth, backend, dispersion=dispersion,
                frame=None if fold else (g * nloc, nloc * self.n_devices))
            new_total.append(t + res.radiance)
            rays.append(res.rays_traced)
        samples = samples + 1
        return (new_total, samples, [t / samples for t in new_total],
                _sum_devices(self.mesh, rays))

    def render_samples(self, scene_data, ro, rd, total, samples, base_key,
                       counter0, n_steps, max_depth, backend="auto",
                       dispersion=False, jitter_cam=None, chunks=1):
        """``engine.render_samples`` over the tiles (``total``, one tensor
        per device, accumulated in place), each device under
        ``fold_device=dev`` or, without the fold, with its columns of the
        frame's draws (see :func:`device_fold`). ``chunks > 1`` traces each
        tile as ``chunks`` sub-wavefronts; ``jitter_cam`` is
        :meth:`shard_jitter_cam`'s list."""
        nloc = ro[0].shape[0]
        if chunks > 1:
            if jitter_cam is not None:
                raise ValueError("chunks > 1 does not support jitter_cam")
            if nloc % chunks:
                raise ValueError(f"chunks={chunks} must divide the "
                                 f"per-device tile width {nloc}")
        scenes = self.shard_scene(scene_data)
        fold = self.folds_device(engine.resolve_backend(
            backend, scene_data.n_triangles, self.mesh.devices[0]), chunks)
        cams = jitter_cam if jitter_cam is not None else [None] * len(ro)
        out, rays = [], []
        for (_, g), sc, o, r, t, jc in zip(self._local(), scenes, ro, rd,
                                           total, cams):
            _, _, o_t, n_t = engine.render_samples(
                sc, o, r, t, samples, base_key, counter0, n_steps=n_steps,
                max_depth=max_depth, backend=backend, dispersion=dispersion,
                jitter_cam=jc, chunks=chunks,
                fold_device=g if fold else None,
                frame=None if fold else (g * nloc, nloc * self.n_devices))
            out.append(o_t)
            rays.append(n_t)
        return (total, samples + n_steps, out,
                _sum_devices(self.mesh, rays))

    def gather(self, out) -> torch.Tensor:
        """The whole [N, nw] image on the mesh's first device, padding
        dropped; across processes every rank gets it."""
        first = self.mesh.devices[0]
        local = torch.cat([t.to(first) for t in out])
        if self.mesh.distributed:
            parts = [torch.empty_like(local)
                     for _ in range(self.mesh.world_size)]
            dist.all_gather(parts, local)
            local = torch.cat(parts)
        return local[:self._true_n] if self._true_n is not None else local


class SppAllreduce(_Strategy):
    """Each device renders the full image; radiance summed over the mesh."""

    name = "spp"

    def folds_device(self, backend: str, chunks: int = 1) -> bool:
        return True

    def shard_rays(self, ro, rd):
        """The whole frame's rays on every local device."""
        return ([ro.to(d) for d in self.mesh.devices],
                [rd.to(d) for d in self.mesh.devices])

    def zeros_accumulator(self, n, nw):
        return torch.zeros((n, nw), dtype=torch.float32,
                           device=self.mesh.devices[0])

    def shard_accumulator(self, total):
        return total.to(self.mesh.devices[0])

    def gather(self, out) -> torch.Tensor:
        return out

    def render_sample(self, scene_data, ro, rd, total, samples, key,
                      max_depth, backend="dense", dispersion=False):
        """One step = ``mesh.size`` samples: device ``dev`` traces under
        ``fold_in(key, dev)``, the radiance summed over the mesh."""
        scenes = self.shard_scene(scene_data)
        res = [engine.trace_radiance(sc, o, r,
                                     rng.fold_in(key,
                                                 self.mesh.global_index(i)),
                                     max_depth, backend,
                                     dispersion=dispersion)
               for i, (sc, o, r) in enumerate(zip(scenes, ro, rd))]
        total = total + _sum_devices(self.mesh, [x.radiance for x in res])
        samples = samples + self.n_devices
        return (total, samples, total / samples,
                _sum_devices(self.mesh, [x.rays_traced for x in res]))

    def render_samples(self, scene_data, ro, rd, total, samples, base_key,
                       counter0, n_steps, max_depth, backend="auto",
                       dispersion=False):
        """Batched: one call adds ``n_steps * mesh.size`` samples; device
        ``dev``'s sample ``i`` traces under ``fold_in(fold_in(base_key,
        counter0 + i), dev)``, so streams stay disjoint across both axes
        and resume is exact."""
        scenes = self.shard_scene(scene_data)
        rads, rays = [], []
        for i, (sc, o, r) in enumerate(zip(scenes, ro, rd)):
            acc = torch.zeros_like(total, device=o.device)
            _, _, _, n_t = engine.render_samples(
                sc, o, r, acc, 0, base_key, counter0, n_steps=n_steps,
                max_depth=max_depth, backend=backend, dispersion=dispersion,
                fold_device=self.mesh.global_index(i))
            rads.append(acc)
            rays.append(n_t)
        total = total + _sum_devices(self.mesh, rads)
        samples = samples + n_steps * self.n_devices
        return (total, samples, total / samples,
                _sum_devices(self.mesh, rays))


def tile_shard_trace(mesh: Mesh, scene_data, ro, rd, key, max_depth,
                     backend="auto", rand_override=None, dispersion=False,
                     fold_device=True):
    """``engine.trace_radiance`` on each device's tile (``ro``/``rd``:
    ``TileSharding.shard_rays``' lists). With ``fold_device`` each device
    folds its mesh index into the key; with ``fold_device=False`` and a
    ``rand_override`` ([2*max_depth, 4, N_pad], cut into the tiles' columns
    here) every tile is bitwise the unsharded trace of its rays. Returns
    (radiance tiles, rays_traced summed over the mesh)."""
    nloc = ro[0].shape[0]
    rad, rays = [], []
    for i, (d, o, r) in enumerate(zip(mesh.devices, ro, rd)):
        g = mesh.global_index(i)
        k = rng.fold_in(key, g) if fold_device else key
        rand = (None if rand_override is None else
                rand_override[..., g * nloc:(g + 1) * nloc].to(d))
        res = engine.trace_radiance(_scene_on(scene_data, d), o, r, k,
                                    max_depth, backend, rand_override=rand,
                                    dispersion=dispersion)
        rad.append(res.radiance)
        rays.append(res.rays_traced)
    return rad, _sum_devices(mesh, rays)


def per_device_rays(mesh: Mesh, scene_data, ro, rd, key, max_depth,
                    backend="auto") -> np.ndarray:
    """[mesh.size] rays traced by each device for one tile-sharded sample
    (each device's key folded with its index): the observable that the
    tiles strategy divides the work."""
    local = [engine.trace_radiance(
        _scene_on(scene_data, d), o, r, rng.fold_in(key, mesh.global_index(i)),
        max_depth, backend).rays_traced.to(mesh.devices[0])
        for i, (d, o, r) in enumerate(zip(mesh.devices, ro, rd))]
    counts = torch.stack(local)
    if mesh.distributed:
        parts = [torch.empty_like(counts) for _ in range(mesh.world_size)]
        dist.all_gather(parts, counts)
        counts = torch.cat(parts)
    return counts.cpu().numpy()
