"""PyTorch/CUDA port of the spectral path tracer.

A second package beside ``pathtracing_spectrum_tpu`` (the JAX reference).
It imports ``torch`` and never ``jax``: the JAX package's ``__init__``
imports modules that import jax at module level, so even its numpy-only
host layer cannot be reused by import on a machine without jax. The host
layer this package needs (OBJ parsing, triangle SoA, scene compilation,
shading-table packing, intersection precompute, scene files and spectral
text) is therefore carried here as a jax-free copy, and the CPU tests hold
it equal to the JAX package, array for array and byte for byte.

The port covers the main path, the large-scene path, the spectral path,
the user's session and the user's surface: BVH-ordered scene compilation
(the binned-SAH builder, host C++) with normal and roughness maps (image
files decoded without PIL) and temperature grids, the closest-hit kernels K1
(dense sweep), K3 (BVH walk, the ``hier`` backend) and K4 (cluster-culled
sweep), the attribute fetch K2 and the threefry draw of ``jax.random``
(hand-written CUDA kernels under ``csrc/``), the bounce loop in every
spectral mode (dense, hero, Cauchy dispersion) with the bounce-ray reorder,
``render_samples`` under JAX's key schedule (``ops/rng.py``;
``rng.key(seed)`` makes a key) with the primary-hit hoist, chunked
wavefronts and batched camera jitter, the progressive ``RenderSession``
(start/pause/resume/stop/restart, an async loop, checkpoints that resume in
either package, ``result_srgb`` through the sRGB epilogue on the card), the
authoring API of ``Scene``, ``.pts`` scene files (``utils/scene_io.py``)
and ASCII spectra (``utils/spectral_io.py``), the viewer (``viewer.py``,
images written without PIL in the format their extension names), the
headlight preview and pick through K1/K3 (``preview.py``), the interactive shell (``shell.py``), multi-device
rendering (``parallel/``: ``TileSharding`` and ``SppAllreduce`` over a
device mesh, across processes through ``torch.distributed``, NCCL between
cards and gloo between CPU processes), the command line (``python -m
pathtracing_spectrum_tpu_torch``) and the host's file readers and writers
(the host library built from ``csrc/``: the native OBJ parser and
spectral writer, the JPEG decoder and encoder, the LZW and PackBits
decoders and the WebP decoder beside the numpy PNG, BMP, TGA, PNM, GIF,
TIFF and PSD code of ``utils/image.py``). Not ported yet (ROADMAP Queue 1): the
port's benchmark (item 5; ``cli bench`` raises ``NotImplementedError``
naming it).
"""

from .constants import (BIG, EPS, INF, SCENE_FILE_HEADER, SCENE_FILE_VERSION,
                        __version__)
from .models.materials import Material, MaterialType, SpectrumMaterial
from .models.camera import (Camera, JitterCam, camera_rays,
                            jitter_cam_arrays, jittered_dirs)
from .scene import (Scene, SceneData, SceneElement, SceneObject,
                    scene_data_from_numpy)
from .ops import rng
from .ops.wave import Wave
from .engine import (make_intersector, render_sample, render_samples,
                     resolve_backend, trace_radiance)
from .render import KEY_SCHEDULE_VERSION, RenderSession, RenderStatus

__all__ = [
    "BIG", "EPS", "INF", "SCENE_FILE_HEADER", "SCENE_FILE_VERSION",
    "__version__",
    "Material", "MaterialType", "SpectrumMaterial",
    "Camera", "JitterCam", "camera_rays", "jitter_cam_arrays",
    "jittered_dirs",
    "Scene", "SceneData", "SceneElement", "SceneObject",
    "scene_data_from_numpy",
    "make_intersector", "render_sample", "render_samples",
    "resolve_backend", "trace_radiance",
    "KEY_SCHEDULE_VERSION", "RenderSession", "RenderStatus", "rng",
    "Wave",
]
