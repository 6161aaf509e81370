"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the host
(``device="cpu"``, ``--device cpu``). Nothing detects the device and falls
back: with no card and no ``cpu`` request, :func:`resolve_device` raises.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; raises when that card is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless asked for the "
            "host (pass device='cpu' / --device cpu)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
