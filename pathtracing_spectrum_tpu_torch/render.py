"""Progressive render session: the host-side state machine.

Port of ``pathtracing_spectrum_tpu/render.py::RenderSession``. The session
runs on the card unless it is built with ``device="cpu"``, or on a device
mesh with ``sharding=`` (``parallel.TileSharding`` or
``parallel.SppAllreduce``; its device is then the mesh's first):

* ``start()``   — (re)compiles the scene onto the device when it changed,
  makes the primary rays in 32x32 tile order, and resets the accumulator
  when coming from STOPPED/IDLE (main.cpp:4010-4027);
* ``pause()``/``resume()`` — keep the accumulator (main.cpp:4034-4039);
* ``stop()``    — the next start resets (pathtracer.cpp:547-556);
* ``restart()`` — reset now and keep rendering;
* ``step(n)``   — ``n`` progressive samples in one
  ``engine.render_samples`` call (chunked with ``chunks``, re-jittered per
  sample with ``jitter``);
* ``run(target_spp)`` — render to the target and pause, 0 = unbounded
  (main.cpp:4057-4061);
* ``start_async()``/``join()`` — the same loop on a background thread,
  stopped by ``stop()``;
* ``save_checkpoint``/``load_checkpoint`` — the JAX session's npz file:
  the same fields, dtypes and refusals, so a checkpoint that either
  package writes resumes exactly in the other; the port's file also
  records the sharding, the mesh size and the device fold, and a resume
  under others is refused;
* ``result()``/``result_srgb()`` — the running mean as spectra, or as
  sRGB through the device epilogue.

The session's key is ``jax.random.key(seed)`` (``ops/rng.py``) and sample
``i`` traces under ``fold_in(key, i)``, so a port session and a JAX session
with one seed draw the same variates; ``KEY_SCHEDULE_VERSION`` is the JAX
package's, since the schedule is its schedule bit for bit.
"""

from __future__ import annotations

import contextlib
import enum
import threading
import time
import warnings
from typing import Optional

import numpy as np
import torch

from .device import DEFAULT_DEVICE, resolve_device
from .engine import JITTER_FOLD, render_samples, resolve_backend
from .models.camera import camera_rays, jitter_cam_arrays, tile_order
from .ops import rng
from .scene import Scene, SceneData

MAX_TARGET_SPP = 65535  # reference GUI clamp (main.cpp:1662-1669)

# The JAX package's version of the per-sample key derivation; a checkpoint
# from another schedule would resume with another random sequence, so
# load_checkpoint refuses it.
KEY_SCHEDULE_VERSION = 1


def _each(fn, x):
    """``fn`` of a tensor, or of each device's tensor of a sharded one (a
    ``TileSharding`` list)."""
    return [fn(t) for t in x] if isinstance(x, list) else fn(x)


class RenderStatus(enum.Enum):
    IDLE = "idle"
    RENDERING = "rendering"
    PAUSED = "paused"
    STOPPED = "stopped"


class RenderSession:
    """Owns the progressive accumulator for one scene + camera."""

    def __init__(self, scene: Scene,
                 device: "torch.device | str" = DEFAULT_DEVICE,
                 seed: int = 0, backend: str = "auto", dispersion=False,
                 jitter: bool = False, auto_backend_threshold: int = 4096,
                 resolution: Optional[tuple] = None, sharding=None,
                 tile_ordering: bool = True, chunks: int = 1):
        if chunks > 1 and jitter:
            raise ValueError("chunks > 1 (bounded-width wavefront) "
                             "does not support jitter (yet)")
        if (chunks > 1 and sharding is not None
                and not sharding.supports_chunks):
            raise ValueError("chunks > 1 composes only with a sharding "
                             "that supports it (TileSharding does; "
                             "SppAllreduce renders full frames per device "
                             "and does not)")
        if auto_backend_threshold != 4096:
            # the JAX session's signature; there too it changes nothing
            raise ValueError(
                f"auto_backend_threshold={auto_backend_threshold} has no "
                "effect: backend='auto' resolves by the engine's per-device "
                "triangle counts (engine.resolve_backend)")
        self.scene = scene
        self._sharding = sharding
        self.device = (sharding.mesh.devices[0] if sharding is not None
                       else resolve_device(device))
        self.seed = int(seed)
        self.backend = backend   # handed to the engine; "auto" resolves there
        self.dispersion = dispersion
        self.jitter = bool(jitter)
        self.chunks = int(chunks)
        self._resolution_override = resolution
        self._tile_ordering = tile_ordering

        self.status = RenderStatus.IDLE
        self.target_spp: int = 0   # 0 = unbounded (reference semantics)

        self._scene_data: Optional[SceneData] = None
        self._dirty = True
        self._synced_version = -1
        self._ro = self._rd = None
        self._jitter_cam = None
        self._perm = self._inv_perm = None
        self._inv_perm_dev = None  # made by result_srgb at first use
        self._total = None
        self._out = None
        self._samples = 0
        self._key = rng.key(self.seed)
        self._sample_counter = 0   # fold_in counter, for exact resume

        self.elapsed = 0.0
        self.rays_traced = 0
        self.last_sample_time = 0.0

        self._thread: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None
        self._stop_evt = threading.Event()
        self._lock = threading.Lock()

    # -- scene/camera sync ---------------------------------------------------
    def mark_dirty(self) -> None:
        """Scene or camera changed: re-sync on the next start."""
        self._dirty = True

    @property
    def resolution(self):
        return self._resolution_override or self.scene.resolution

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
        cam = self.scene.camera()
        # the rays are made and permuted on the host, then moved: the same
        # float32 rays on every device
        ro, rd = camera_rays(cam, w, h, "cpu")
        if self._tile_ordering:
            # compact 32x32 screen tiles per ray block
            self._perm, self._inv_perm = tile_order(w, h)
            self._inv_perm_dev = None
            perm_t = torch.from_numpy(self._perm.astype(np.int64))
            ro, rd = ro[perm_t], rd[perm_t]
        sh = self._sharding
        self._ro, self._rd = (sh.shard_rays(ro, rd) if sh is not None
                              else (ro.to(self.device), rd.to(self.device)))
        self._jitter_cam = (jitter_cam_arrays(cam, w, h, self._perm,
                                              self.device)
                            if self.jitter else None)
        if self._jitter_cam is not None and sh is not None \
                and sh.supports_jitter_cam:
            self._jitter_cam = sh.shard_jitter_cam(self._jitter_cam)
        self._dirty = False
        self._reset_accumulator()

    def _reset_accumulator(self) -> None:
        w, h = self.resolution
        nw = len(self.scene.wavelengths)
        if self._sharding is not None:
            self._total = self._sharding.zeros_accumulator(w * h, nw)
        else:
            self._total = torch.zeros((w * h, nw), dtype=torch.float32,
                                      device=self.device)
        self._out = _each(torch.zeros_like, self._total)
        self._samples = 0
        self._sample_counter = 0
        self.elapsed = 0.0
        self.rays_traced = 0

    # -- state machine ---------------------------------------------------------
    def start(self) -> None:
        # re-sync when the scene graph has changed since the last sync
        if self.scene.version != self._synced_version:
            self._dirty = True
        if self.status == RenderStatus.PAUSED and not self._dirty:
            self.status = RenderStatus.RENDERING
            return
        if self._dirty or self.status in (RenderStatus.STOPPED,
                                          RenderStatus.IDLE):
            self._sync()
        self.status = RenderStatus.RENDERING

    def pause(self) -> None:
        if self.status == RenderStatus.RENDERING:
            self.status = RenderStatus.PAUSED

    def resume(self) -> None:
        if self.status == RenderStatus.PAUSED:
            self.status = RenderStatus.RENDERING

    def stop(self) -> None:
        self.status = RenderStatus.STOPPED
        self._stop_evt.set()

    def restart(self) -> None:
        if self._dirty:
            self._sync()
        else:
            self._reset_accumulator()
        self.status = RenderStatus.RENDERING

    # -- rendering ---------------------------------------------------------------
    def step(self, n_samples: int = 1, readback: bool = True):
        """Render ``n_samples`` progressive samples in one
        ``render_samples`` call (the sharding's, with one); returns the
        running mean as [H, W, nw] (or None with ``readback=False``).

        A sharding without batched jitter (``SppAllreduce``) renders a
        jittered session one ``render_sample`` at a time, as the JAX
        session does: sample ``i`` under ``k = fold_in(key, i)``, its rays
        through ``camera_rays(..., key=fold_in(k, 0xC0FFEE), jitter=True)``
        (made on the host, as :meth:`_sync` makes them) and the device fold
        inside the sharding."""
        if self.status != RenderStatus.RENDERING:
            self.start()
        t0 = time.perf_counter()
        sh = self._sharding
        if n_samples >= 1 and (sh is None or sh.supports_jitter_cam
                               or not self.jitter):
            step_fn = sh.render_samples if sh is not None else render_samples
            kw = {"jitter_cam": self._jitter_cam} if self.jitter else {}
            if self.chunks > 1:
                kw["chunks"] = self.chunks
            self._total, self._samples, self._out, rays = step_fn(
                self._scene_data, self._ro, self._rd, self._total,
                self._samples, self._key, self._sample_counter,
                n_steps=n_samples, max_depth=self.scene.trace_depth,
                backend=self.backend, dispersion=self.dispersion, **kw)
            self._sample_counter += n_samples
            self.rays_traced += int(rays)   # waits for the device
        else:
            w, h = self.resolution
            for _ in range(n_samples):
                key = rng.fold_in(self._key, self._sample_counter)
                ro, rd = camera_rays(self.scene.camera(), w, h, "cpu",
                                     key=rng.fold_in(key, JITTER_FOLD),
                                     jitter=True)
                if self._perm is not None:
                    perm_t = torch.from_numpy(self._perm.astype(np.int64))
                    ro, rd = ro[perm_t], rd[perm_t]
                ro, rd = sh.shard_rays(ro, rd)
                self._total, self._samples, self._out, rays = sh.render_sample(
                    self._scene_data, ro, rd, self._total, self._samples, key,
                    max_depth=self.scene.trace_depth, backend=self.backend,
                    dispersion=self.dispersion)
                self._sample_counter += 1
                self.rays_traced += int(rays)
        dt = time.perf_counter() - t0
        self.elapsed += dt
        self.last_sample_time = dt / max(n_samples, 1)
        return self.result() if readback else None

    def run(self, target_spp: Optional[int] = None,
            batch: int = 8) -> np.ndarray:
        """Render until ``target_spp`` samples (``self.target_spp`` when
        None; 0 = until stopped from elsewhere), ``batch`` per step, then
        pause (main.cpp:4057-4061)."""
        target = min(target_spp if target_spp is not None
                     else self.target_spp, MAX_TARGET_SPP)
        batch = max(1, batch)
        self.start()
        while (self.status == RenderStatus.RENDERING
               and (target == 0 or self.samples < target)):
            n = batch if target == 0 else min(batch, target - self.samples)
            self.step(n, readback=False)
            if target and self.samples >= target:
                self.pause()
        return self.result()

    # -- async loop (the reference's tracer-thread analogue) -------------------
    def start_async(self, target_spp: Optional[int] = None) -> None:
        """Render one sample at a time on a background thread until
        ``stop()``, pausing at ``target_spp`` (0 = unbounded). The thread
        launches on the session's device; an exception that ends it is
        raised again by :meth:`join`."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self._async_error = None
        target = min(target_spp if target_spp is not None
                     else self.target_spp, MAX_TARGET_SPP)

        def loop():
            # the current CUDA device is per thread
            on_device = (torch.cuda.device(self.device)
                         if self.device.type == "cuda"
                         else contextlib.nullcontext())
            try:
                with on_device:
                    self.start()
                    while not self._stop_evt.is_set():
                        if self.status != RenderStatus.RENDERING:
                            time.sleep(0.01)
                            continue
                        with self._lock:
                            self.step(1, readback=False)
                        if target and self.samples >= target:
                            self.pause()
            except Exception as e:   # the thread's boundary: join() raises it
                self._async_error = e

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise err

    # -- results & stats --------------------------------------------------------
    @property
    def samples(self) -> int:
        return self._samples

    def result(self) -> np.ndarray:
        """Running mean as [H, W, nw] (row 0 = image top)."""
        w, h = self.resolution
        nw = len(self.scene.wavelengths)
        if self._out is None:
            return np.zeros((h, w, nw), np.float32)
        out = self._gathered(self._out).cpu().numpy()
        if self._inv_perm is not None:
            out = out[self._inv_perm]
        return out.reshape(h, w, nw)

    def _gathered(self, x) -> torch.Tensor:
        """The whole [N, nw] frame of an accumulator-shaped value, on the
        session's device (the mesh's first, gathered by the sharding)."""
        return self._sharding.gather(x) if self._sharding is not None else x

    def result_srgb(self, exposure: float = 0.0) -> np.ndarray:
        """Running mean as uint8 sRGB [H, W, 3] through the device epilogue
        (``viewer.spectral_to_srgb_device``) on the accumulator's device:
        only [N, 3] uint8 is read back, never the [N, nw] float32 spectra.
        The epilogue is per pixel plus one global percentile, so it
        commutes with the tile-order unscramble, applied after, on the
        uint8 result and on the same device (at 4K a host gather took 199
        ms, the device's 1 ms: ``tools/srgb_epilogue.py``). Without an
        accumulator, the host path on :meth:`result`."""
        from . import viewer

        w, h = self.resolution
        if self._out is None:
            return viewer.spectral_to_srgb(self.result(),
                                           self.scene.wavelengths,
                                           exposure=exposure)
        srgb = viewer.spectral_to_srgb_device(
            self._gathered(self._out), self.scene.wavelengths,
            exposure=exposure)
        if self._inv_perm is not None:
            if self._inv_perm_dev is None:
                self._inv_perm_dev = torch.from_numpy(
                    self._inv_perm.astype(np.int64)).to(self.device)
            srgb = srgb.index_select(0, self._inv_perm_dev)
        return srgb.cpu().numpy().reshape(h, w, 3)

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

    # -- checkpoint/resume --------------------------------------------------------
    def _sharding_record(self) -> tuple:
        """(strategy, mesh size, device fold) of this session's sample
        stream: ``("none", 1, False)`` without a sharding."""
        sh = self._sharding
        if sh is None:
            return "none", 1, False
        return (sh.name, sh.mesh.size,
                sh.folds_device(self.resolved_backend(), self.chunks))

    def save_checkpoint(self, path: str) -> None:
        """Write the accumulator (in scanline order), the sample count and
        counter, the seed and what the resume must match, as the JAX
        session's npz (``samples`` a 0-d int32, so the JAX session loads
        it too), plus the sharding, mesh size and device fold (which the
        JAX package does not record, and ignores)."""
        if self._total is None:
            raise RuntimeError("nothing to save: start() the session first")
        total = self._gathered(self._total).cpu().numpy()
        if self._inv_perm is not None:
            total = total[self._inv_perm]   # persist in scanline order
        np.savez(path,
                 total=total,
                 samples=np.asarray(self._samples, np.int32),
                 sample_counter=self._sample_counter,
                 seed=self.seed,
                 resolution=np.asarray(self.resolution),
                 n_waves=len(self.scene.wavelengths),
                 scene_hash=self.scene.content_digest(),
                 backend=self.resolved_backend(),
                 jitter=self.jitter,
                 chunks=self.chunks,
                 key_schedule=KEY_SCHEDULE_VERSION,
                 **dict(zip(("sharding", "mesh_size", "device_fold"),
                            self._sharding_record())))

    def load_checkpoint(self, path: str) -> None:
        """Resume from a checkpoint either package wrote, refusing one whose
        resolution, wavelength count, scene, key schedule, jitter, chunks,
        sharding, mesh size or device fold differ from this session's; the
        session is then PAUSED. A file without the sharding fields (every
        JAX file) resumes into an unsharded session, and into a sharded one
        with a warning."""
        data = np.load(path)
        if tuple(data["resolution"]) != tuple(self.resolution):
            raise ValueError("checkpoint resolution mismatch")
        if int(data["n_waves"]) != len(self.scene.wavelengths):
            raise ValueError("checkpoint wavelength-count mismatch")
        # same shapes are not enough: a checkpoint of another scene refuses
        if "scene_hash" in data.files:
            ck_hash = str(data["scene_hash"])
            here = self.scene.content_digest()
            if ck_hash != here:
                raise ValueError(
                    f"checkpoint scene mismatch: checkpoint was written for "
                    f"scene {ck_hash[:12]}, this session's scene is "
                    f"{here[:12]} (same shapes do not imply same scene)")
            if int(data["key_schedule"]) != KEY_SCHEDULE_VERSION:
                raise ValueError(
                    f"checkpoint RNG key-schedule version "
                    f"{int(data['key_schedule'])} != {KEY_SCHEDULE_VERSION}; "
                    f"resuming would change the random sequence")
            ck_backend = str(data["backend"])
            if ck_backend != self.resolved_backend():
                warnings.warn(
                    f"checkpoint was rendered with backend '{ck_backend}', "
                    f"resuming with '{self.resolved_backend()}' (hit "
                    f"selection is bit-identical across backends, but noting "
                    f"the switch)", stacklevel=2)
        else:
            warnings.warn("legacy checkpoint without a scene hash — cannot "
                          "verify it matches this scene", stacklevel=2)
        ck_jitter = bool(data["jitter"]) if "jitter" in data.files else False
        if ck_jitter != self.jitter:
            raise ValueError(
                f"checkpoint was rendered with jitter={ck_jitter}, this "
                f"session has jitter={self.jitter} — the per-sample ray "
                f"schedule differs, resume would not be exact")
        for engine in ("compact", "persistent"):   # retired JAX engines
            if engine in data.files and bool(data[engine]):
                raise ValueError(f"checkpoint was rendered by the retired "
                                 f"{engine} engine — resume is not possible")
        ck_chunks = int(data["chunks"]) if "chunks" in data.files else 1
        if ck_chunks != self.chunks:
            raise ValueError(
                f"checkpoint was rendered with chunks={ck_chunks}, this "
                f"session has chunks={self.chunks} — the per-chunk key "
                f"fold differs, resume would not be exact")
        if self._dirty:
            self._sync()
        # after the sync: the device fold follows the resolved backend
        mine = self._sharding_record()
        if "sharding" in data.files:
            theirs = (str(data["sharding"]), int(data["mesh_size"]),
                      bool(data["device_fold"]))
            if theirs != mine:
                raise ValueError(
                    f"checkpoint was rendered with sharding={theirs[0]} on "
                    f"{theirs[1]} devices (device fold {theirs[2]}), this "
                    f"session has sharding={mine[0]} on {mine[1]} devices "
                    f"(device fold {mine[2]}) — the per-device key folds "
                    f"differ, resume would not be exact")
        elif self._sharding is not None:
            warnings.warn("checkpoint without a sharding record (written by "
                          "the JAX package) — cannot verify it was rendered "
                          f"with sharding={mine[0]} on {mine[1]} devices",
                          stacklevel=2)
        total = data["total"]
        if self._perm is not None:
            total = total[self._perm]
        total = torch.tensor(total, dtype=torch.float32)
        self._total = (self._sharding.shard_accumulator(total)
                       if self._sharding is not None
                       else total.to(self.device))
        self._samples = int(data["samples"])
        self._out = _each(lambda t: t / float(max(self._samples, 1)),
                          self._total)
        self._sample_counter = int(data["sample_counter"])
        self.seed = int(data["seed"])
        self._key = rng.key(self.seed)
        self.status = RenderStatus.PAUSED
