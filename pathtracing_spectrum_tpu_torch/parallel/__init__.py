"""Multi-device rendering (port of ``pathtracing_spectrum_tpu/parallel``):
a 1-D device mesh over ``torch.distributed`` (``mesh.py``) and the two
strategies that run the engine on it, ``TileSharding`` and
``SppAllreduce`` (``tiling.py``)."""

from .mesh import TILE_AXIS, Mesh, initialize_multihost, make_mesh
from .tiling import (SppAllreduce, TileSharding, per_device_rays,
                     tile_shard_trace)

__all__ = ["TILE_AXIS", "Mesh", "initialize_multihost", "make_mesh",
           "SppAllreduce", "TileSharding", "per_device_rays",
           "tile_shard_trace"]
