"""The port's device rule: every entry point runs on the card unless the
caller asks for the CPU.

``resolve_device(None)`` is ``cuda:0``.  Without a CUDA device it raises
instead of moving the run to the CPU on its own: a run that silently left
the card would report host timings under a device's name.  Pass
``device="cpu"`` explicitly (the CPU tests do) to run the plain PyTorch
versions of the kernels on the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["default_device", "resolve_device"]

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "linna_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda:0")


def resolve_device(device: Optional[DeviceLike] = None) -> torch.device:
    if device is None:
        return default_device()
    return torch.device(device)
