"""The benchmark's weights, drawn from ``--seed`` on the device.

The rule is the port's parity tests' (N(0, 1/fan_in) for every matrix,
zero norm scales), drawn here with one ``torch.Generator`` on the card,
one ``normal_`` call a leaf, in the dtype the model is served in. The tree
is the reference's ``param_shapes``; the same tensors go to the program and
to the reference."""
from __future__ import annotations

from typing import Dict

import torch


def draw(spec: Dict, seed: int, device, dtype) -> Dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))

    def make(leaf):
        if isinstance(leaf, dict):
            return {k: make(v) for k, v in leaf.items()}
        shape, fan_in = leaf
        if fan_in is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        t = torch.empty(shape, dtype=dtype, device=device)
        return t.normal_(0.0, fan_in ** -0.5, generator=gen)

    return make(spec)


def spec_shapes(spec) -> Dict:
    """The shapes of a (shape, fan_in) spec tree."""
    if isinstance(spec, dict):
        return {k: spec_shapes(v) for k, v in spec.items()}
    return tuple(spec[0])
