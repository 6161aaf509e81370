"""Compile accounting: ``TraceStats`` + ``counting_call``.

Bounded compile counts are a serving invariant of the reference: with
length bucketing, the number of prefill executables can never exceed the
bucket count, whatever the traffic. PyTorch runs eagerly and compiles
nothing, but the invariant is still what the engine's stats report, so
every engine step goes through :func:`counting_call`, which counts one
"compile" per new abstract signature of its arguments — exactly where
``jax.jit`` would trace a new executable. ``prefill_compiles`` and
``decode_compiles`` keep the reference's meaning, and the two can be
compared call for call.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


class TraceStats:
    """Per-step-family signature counters.

    One counter per step name ("prefill", "decode", ...): ``counting_call``
    bumps it whenever a call presents an abstract input signature (nesting
    structure + tensor shapes/dtypes/devices + static values) the wrapper has
    not seen before.
    """

    def __init__(self):
        self.compile_counts: Dict[str, int] = {}
        self.call_counts: Dict[str, int] = {}

    def record(self, name: str, new_trace: bool):
        self.call_counts[name] = self.call_counts.get(name, 0) + 1
        if new_trace:
            self.compile_counts[name] = self.compile_counts.get(name, 0) + 1

    def compiles(self, name: Optional[str] = None) -> int:
        if name is not None:
            return self.compile_counts.get(name, 0)
        return sum(self.compile_counts.values())

    def calls(self, name: str) -> int:
        return self.call_counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        return dict(self.compile_counts)


def _describe(x):
    """Abstract description of one argument, recursing into containers.

    Tensors are described by shape, dtype and device. Python ints and
    floats are dynamic scalars, as the reference's ``jnp.int32`` scalars
    are traced values: their value never makes a new signature. Anything
    else is static and described by its value."""
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), str(x.dtype), x.device.type)
    if isinstance(x, dict):
        return ("dict",) + tuple((k, _describe(v)) for k, v in x.items())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_describe(v) for v in x)
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return ("scalar", type(x).__name__)
    return ("py", type(x).__name__, repr(x))


def abstract_signature(args, kwargs):
    """Hashable abstract signature of a call."""
    return (_describe(args), _describe(dict(sorted(kwargs.items()))))


def counting_call(fn, name: str, stats: Optional[TraceStats] = None,
                  on_compile=None):
    """``fn`` wrapped with signature accounting.

    A call whose abstract signature the wrapper has not seen counts as one
    compile on ``stats`` and fires ``on_compile(name)`` (the hook engines use
    to surface compile activity through telemetry counters)."""
    seen = set()

    def wrapper(*args, **kwargs):
        sig = abstract_signature(args, kwargs)
        new = sig not in seen
        if new:
            seen.add(sig)
        out = fn(*args, **kwargs)
        if stats is not None:
            stats.record(name, new)
        if new and on_compile is not None:
            on_compile(name)
        return out

    return wrapper
