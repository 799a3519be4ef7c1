"""The device an entry point runs on.

Every entry point of the port that takes a ``device`` defaults to the card,
``"cuda"``; the CPU runs only when the caller asks for it (the CPU tests
pass ``device="cpu"``, and there the kernel wrappers take their plain
versions). Asking for a CUDA device where there is none raises
:class:`RuntimeError` naming it: nothing carries on on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: "torch.device | str" = DEFAULT_DEVICE
                   ) -> torch.device:
    """``torch.device(device)``, refused with a ``RuntimeError`` when it is a
    CUDA device and this process sees none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for, but torch sees no CUDA "
            "device; pass device='cpu' to run the port's plain versions on "
            "the CPU")
    return dev
