"""Progressive render session (synchronous subset).

Port of ``pathtracing_spectrum_tpu/render.py::RenderSession``: ``start``
compiles the scene and the primary rays onto the session's device (in
32x32 tile order, as the JAX session does), ``step(n)`` renders ``n``
samples through one ``engine.render_samples`` call, ``run`` steps until a
target sample count and pauses, ``result`` un-permutes the running mean to
[H, W, nw], ``stats`` reports samples, time, Mrays/s and the backend that
``"auto"`` resolved to (``resolved_backend``). The session runs on the
card unless it is built with ``device="cpu"``. The session's key is
``jax.random.key(seed)`` of the JAX session (``ops/rng.py``) and sample
``i`` traces under ``fold_in(key, i)``, so a port session and a JAX
session with one seed draw the same variates; ``dispersion`` selects the
spectral estimator as in the JAX session.

Not in this slice (ROADMAP Queue 1 item 8): async rendering, stop/restart,
checkpoints, sharding, jitter.
"""

from __future__ import annotations

import enum
import time
from typing import Optional

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device
from .engine import render_samples, resolve_backend
from .models.camera import camera_rays, tile_order
from .ops import rng
from .scene import Scene, SceneData

MAX_TARGET_SPP = 65535  # reference GUI clamp (main.cpp:1662-1669)


class RenderStatus(enum.Enum):
    IDLE = "idle"
    RENDERING = "rendering"
    PAUSED = "paused"


class RenderSession:
    """Owns the progressive accumulator for one scene + camera."""

    def __init__(self, scene: Scene,
                 device: "torch.device | str" = DEFAULT_DEVICE,
                 seed: int = 0, backend: str = "auto", dispersion=False):
        self.scene = scene
        self.device = resolve_device(device)
        self.seed = int(seed)
        self.backend = backend   # handed to the engine; "auto" resolves there
        self.dispersion = dispersion
        self._key = rng.key(self.seed)
        self.status = RenderStatus.IDLE
        self._synced_version = -1
        self._scene_data: Optional[SceneData] = None
        self._ro = self._rd = None
        self._inv_perm = None
        self._total = None
        self._out = None
        self.samples = 0
        self._sample_counter = 0
        self.elapsed = 0.0
        self.rays_traced = 0

    @property
    def resolution(self):
        return self.scene.resolution

    def resolved_backend(self) -> str:
        """The backend the engine runs for the synced scene on this
        session's device (the JAX session's ``resolved_backend``)."""
        n_tris = (self._scene_data.n_triangles
                  if self._scene_data is not None else 0)
        return resolve_backend(self.backend, n_tris, self.device)

    def _sync(self) -> None:
        self._synced_version = self.scene.version
        self._scene_data = self.scene.compile(self.device)
        w, h = self.resolution
        # the rays are made and permuted on the host, then moved: the same
        # float32 rays on every device
        ro, rd = camera_rays(self.scene.camera(), w, h, "cpu")
        # compact 32x32 screen tiles per ray block, permuted on the host
        perm, self._inv_perm = tile_order(w, h)
        perm_t = torch.from_numpy(perm.astype(np.int64))
        self._ro = ro[perm_t].to(self.device)
        self._rd = rd[perm_t].to(self.device)
        nw = len(self.scene.wavelengths)
        self._total = torch.zeros((w * h, nw), dtype=torch.float32,
                                  device=self.device)
        self._out = self._total.clone()
        self.samples = 0
        self._sample_counter = 0
        self.elapsed = 0.0
        self.rays_traced = 0

    def start(self) -> None:
        """(Re)compile when the scene changed since the last sync (or on
        the first start), then render."""
        if (self.scene.version != self._synced_version
                or self.status == RenderStatus.IDLE):
            self._sync()
        self.status = RenderStatus.RENDERING

    def step(self, n_samples: int = 1, readback: bool = True):
        """Render ``n_samples`` progressive samples in one
        ``render_samples`` call; returns the running mean as [H, W, nw]
        (or None with ``readback=False``)."""
        if self.status != RenderStatus.RENDERING:
            self.start()
        t0 = time.perf_counter()
        self._total, self.samples, self._out, rays = render_samples(
            self._scene_data, self._ro, self._rd, self._total, self.samples,
            self._key, self._sample_counter, n_steps=n_samples,
            max_depth=self.scene.trace_depth, backend=self.backend,
            dispersion=self.dispersion)
        self._sample_counter += n_samples
        self.rays_traced += int(rays)   # waits for the device
        self.elapsed += time.perf_counter() - t0
        return self.result() if readback else None

    def run(self, target_spp: int, batch: int = 8) -> np.ndarray:
        """Render until ``target_spp`` samples, ``batch`` per step, then
        pause (main.cpp:4057-4061)."""
        target = min(int(target_spp), MAX_TARGET_SPP)
        batch = max(1, int(batch))
        self.start()
        while self.samples < target:
            self.step(min(batch, target - self.samples), readback=False)
        self.status = RenderStatus.PAUSED
        return self.result()

    def result(self) -> np.ndarray:
        """Running mean as [H, W, nw] (row 0 = image top)."""
        w, h = self.resolution
        nw = len(self.scene.wavelengths)
        if self._out is None:
            return np.zeros((h, w, nw), np.float32)
        out = self._out.cpu().numpy()[self._inv_perm]
        return out.reshape(h, w, nw)

    def stats(self) -> dict:
        s = self.samples
        return {
            "status": self.status.value,
            "samples": s,
            "elapsed_s": self.elapsed,
            "avg_time_per_sample_s": self.elapsed / s if s else 0.0,
            "rays_traced": self.rays_traced,
            "mrays_per_s": (self.rays_traced / self.elapsed / 1e6
                            if self.elapsed > 0 else 0.0),
            "triangles": (self._scene_data.n_triangles
                          if self._scene_data is not None else 0),
            "backend": self.resolved_backend(),
            "device": str(self.device),
        }
