"""Device-mesh helpers (port of ``pathtracing_spectrum_tpu/parallel/mesh.py``).

The JAX package's mesh is a 1-D ``jax.sharding.Mesh`` over the devices of
every process, in ``jax.devices()``'s process-major order, and its
collectives ride the TPU interconnect. The port's :class:`Mesh` holds this
process's devices in order and, when a ``torch.distributed`` process group
is up, the rank and world size: the global index of local device ``i`` is
``rank * n_local + i``, JAX's process-major order, and the collectives
across processes go through that group (NCCL between cards, gloo between
CPU processes). Every process holds the same number of devices.

Left out (ROADMAP Queue 1 item 10): ``replicated`` and ``tile_sharded``,
the JAX package's ``NamedSharding``s, and ``make_mesh``'s ``axis_name``.
torch has no sharded tensor: the strategies of ``tiling.py`` keep one
tensor per local device and place each tile on its device themselves.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..device import DEFAULT_DEVICE, resolve_device

TILE_AXIS = "tiles"


class Mesh:
    """A 1-D mesh: this process's devices, its rank and the world size.

    ``size`` is the global device count, ``world_size * len(devices)``.
    ``distributed`` is true when a process group was up when the mesh was
    made; the strategies then combine their results across processes
    through it (with one process too)."""

    def __init__(self, devices: Sequence[torch.device], rank: int = 0,
                 world_size: int = 1, distributed: bool = False):
        self.devices = tuple(devices)
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.distributed = bool(distributed)

    @property
    def size(self) -> int:
        return self.world_size * len(self.devices)

    def global_index(self, i: int) -> int:
        """The mesh index of local device ``i``."""
        return self.rank * len(self.devices) + i

    def __repr__(self) -> str:
        return (f"Mesh(devices={[str(d) for d in self.devices]}, "
                f"rank={self.rank}, world_size={self.world_size})")


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``devices`` (default: every CUDA device this process
    sees; ``RuntimeError`` when torch sees none). A device may repeat: the
    CPU tests pass ``["cpu"] * 8``, and ``["cuda:0"] * 3`` runs three
    tiles on one card. ``"cuda"`` without an index is the current card."""
    if devices is None:
        resolve_device(DEFAULT_DEVICE)
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = []
        for d in devices:
            d = resolve_device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("make_mesh: no devices")
    if dist.is_available() and dist.is_initialized():
        return Mesh(devs, dist.get_rank(), dist.get_world_size(),
                    distributed=True)
    return Mesh(devs)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: "torch.device | str" = DEFAULT_DEVICE
                         ) -> None:
    """Multi-process bring-up (a no-op for one process, as in the JAX
    package): ``torch.distributed.init_process_group`` over
    ``tcp://coordinator_address`` (``host:port``), ``"nccl"`` for a CUDA
    ``device`` (the default) and ``"gloo"`` when the caller asks for the
    CPU. Call it before :func:`make_mesh`. Proven by
    ``tests/test_torch_multihost.py``: two gloo processes form one mesh and
    both hold the merged accumulator."""
    if num_processes is None or num_processes <= 1:
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("initialize_multihost: num_processes > 1 needs a "
                         "coordinator_address and a process_id")
    dev = resolve_device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"initialize_multihost: unsupported device {dev}")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
