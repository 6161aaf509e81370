"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the host
(``device="cpu"``, ``--device cpu``). Nothing detects the device and falls
back: with no card and no ``cpu`` request, :func:`resolve_device` raises.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; raises when that card is missing.
    ``meta`` (shapes and dtypes without storage) is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless asked for the "
            "host (pass device='cpu' / --device cpu)")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def to_device(array, device) -> torch.Tensor:
    """A host array's copy on ``device`` without a host sync.

    A blocking host-to-device copy synchronises the stream, which would add
    a sync per step beside the designed ones; this copies the array (the
    caller may mutate its own afterwards) and lets the driver stage the
    pageable copy while the stream keeps running."""
    return torch.tensor(np.asarray(array)).to(device, non_blocking=True)
