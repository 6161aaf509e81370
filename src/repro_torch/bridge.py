"""Weight bridge: a reference parameter tree with numpy leaves -> the port's
dict of tensors, name for name and shape for shape.

Callers holding reference parameters convert them to numpy first
(``jax.tree.map(np.asarray, params)``); this module imports neither jax
nor the reference package.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device


def params_from_numpy(tree: Mapping, device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None):
    """Map a nested dict of numpy arrays onto a nested dict of tensors on
    ``device``; ``dtype`` None keeps each leaf's own dtype."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, Mapping):
            return {k: conv(v) for k, v in x.items()}
        t = torch.from_numpy(np.array(x))   # a writable host copy
        return t.to(device=dev, dtype=dtype or t.dtype)

    return conv(tree)
