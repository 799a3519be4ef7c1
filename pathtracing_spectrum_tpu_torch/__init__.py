"""PyTorch/CUDA port of the spectral path tracer.

A second package beside ``pathtracing_spectrum_tpu`` (the JAX reference).
It imports ``torch`` and never ``jax``: the JAX package's ``__init__``
imports modules that import jax at module level, so even its numpy-only
host layer cannot be reused by import on a machine without jax. The host
layer this package needs (OBJ parsing, triangle SoA, scene compilation,
shading-table packing, intersection precompute) is therefore carried here
as a jax-free copy, and the CPU tests hold it equal to the JAX package,
array for array.

This slice covers the main path: the dense closest-hit sweep and the
attribute fetch (hand-written CUDA kernels under ``csrc/``), the dense
non-hero bounce loop, ``render_samples`` with the primary-hit hoist, and a
synchronous ``RenderSession``. Everything else raises
``NotImplementedError`` with a pointer to its ROADMAP item.
"""

from .constants import BIG, EPS, __version__
from .models.materials import Material, MaterialType, SpectrumMaterial
from .models.camera import Camera, camera_rays
from .scene import Scene, SceneData, scene_data_from_numpy
from .engine import render_sample, render_samples, trace_radiance
from .render import RenderSession

__all__ = [
    "BIG", "EPS", "__version__",
    "Material", "MaterialType", "SpectrumMaterial",
    "Camera", "camera_rays",
    "Scene", "SceneData", "scene_data_from_numpy",
    "render_sample", "render_samples", "trace_radiance",
    "RenderSession",
]
