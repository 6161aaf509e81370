"""Power sources: what the probes measure.

A :class:`PowerSource` is the ``power(t) -> W`` callable a probe samples.
On DALEK hardware that is the physical node behind the INA228; here it is a
model. Three standard sources cover every consumer in the repo:

``ModelSource``    wraps ``core.energy.ServePowerModel`` — phase-aware
                   roofline/DVFS traces stretched onto measured wall-clock
                   windows (the serving engines);
``MutableSource``  a host-settable constant — the training loop updates it
                   once per step from the utilization model (replaces the
                   old closure-over-``self._power_w`` lambda);
``TraceSource``    replays recorded ``(t, watts)`` arrays (zero-order hold),
                   e.g. a previously captured ``SampleBlock`` or a
                   recorded trace-store stream.

All three evaluate on whole numpy timestamp arrays, which is what lets the
columnar probe path vectorize end to end.

Sampling a ``TraceSource`` past the end of its recording raises
:class:`TraceExhausted` by default — a replay that silently flat-lines
after the data runs out corrupts every downstream energy number. Pass
``on_exhausted="loop"`` to wrap around explicitly, ``"hold"`` to
zero-order-hold the final report, or ``"fill"`` to fall back to ``fill_w``.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np

from repro_torch.core.energy import ServePowerModel


class TraceExhausted(RuntimeError):
    """A ``TraceSource`` was sampled past the end of its recording."""


@runtime_checkable
class PowerSource(Protocol):
    """power(t) in watts; ``t`` may be a float or a numpy array."""

    def __call__(self, t): ...


class MutableSource:
    """Constant power the host updates between sampling windows."""

    def __init__(self, watts: float = 0.0):
        self._watts = float(watts)

    def set(self, watts: float):
        self._watts = float(watts)

    @property
    def watts(self) -> float:
        return self._watts

    def __call__(self, t):
        return self._watts


class ModelSource:
    """Phase-aware power from a :class:`ServePowerModel`.

    Between steps the node idles; during a step the host installs the
    model's trace for that step's token count and measured duration
    (``set_step``), anchored at the step's start time on the session clock.
    """

    def __init__(self, power_model: ServePowerModel):
        self.pm = power_model
        self._trace = None
        self._t0 = 0.0

    def set_step(self, n_tokens: int, wall_s: float, t0: float = 0.0):
        """Install the trace for a step of ``n_tokens`` over ``wall_s``
        seconds starting at absolute time ``t0``."""
        self._trace = self.pm.trace(n_tokens, wall_s)
        self._t0 = t0

    def clear(self):
        self._trace = None

    def __call__(self, t):
        if self._trace is None:
            idle = self.pm.idle_power_w()
            return np.full(np.shape(t), idle) if np.ndim(t) else idle
        return self._trace(t - self._t0)


class TraceSource:
    """Replay of a recorded power trace (zero-order hold: the report at
    ``t_i`` is the average power over ``(t_{i-1}, t_i]``).

    ``on_exhausted`` picks the out-of-range behavior for times past the
    final report:

    ``"raise"``  (default) raise :class:`TraceExhausted` — replays must not
                 silently extrapolate energy that was never recorded;
    ``"loop"``   wrap modulo the final timestamp (the trace is treated as
                 one period anchored at t=0, e.g. a steady-state profile);
    ``"hold"``   zero-order-hold the final report forever;
    ``"fill"``   report ``fill_w`` past the end.
    """

    MODES = ("raise", "loop", "hold", "fill")

    def __init__(self, t: np.ndarray, watts: np.ndarray,
                 fill_w: float = 0.0, on_exhausted: str = "raise"):
        if on_exhausted not in self.MODES:
            raise ValueError(f"on_exhausted={on_exhausted!r} "
                             f"(expected one of {self.MODES})")
        t = np.asarray(t, np.float64)
        order = np.argsort(t, kind="stable")
        self._t = t[order]
        self._w = np.asarray(watts, np.float64)[order]
        self._fill = float(fill_w)
        self._mode = on_exhausted

    @classmethod
    def from_block(cls, block, fill_w: float = 0.0,
                   on_exhausted: str = "raise") -> "TraceSource":
        return cls(block.t, block.watts, fill_w, on_exhausted)

    @property
    def t_end(self) -> float:
        """Timestamp of the final report (0.0 for an empty trace)."""
        return float(self._t[-1]) if self._t.shape[0] else 0.0

    def __len__(self) -> int:
        return int(self._t.shape[0])

    def __call__(self, t):
        if self._t.shape[0] == 0:
            if self._mode == "raise":
                raise TraceExhausted("TraceSource has no recorded samples")
            return np.full(np.shape(t), self._fill) if np.ndim(t) else self._fill
        t_arr = np.asarray(t, np.float64)
        end = self._t[-1]
        if self._mode == "raise" and np.any(t_arr > end):
            raise TraceExhausted(
                f"sampled t={float(np.max(t_arr)):.6f}s past the recording "
                f"end ({float(end):.6f}s); pass on_exhausted='loop' to wrap "
                f"or 'hold'/'fill' to extrapolate explicitly")
        if self._mode == "loop" and end > 0:
            t_arr = np.where(t_arr > end, np.mod(t_arr, end), t_arr)
        idx = np.searchsorted(self._t, t_arr, side="left")
        out = self._w[np.clip(idx, 0, self._w.shape[0] - 1)]
        if self._mode == "fill":
            out = np.where(idx >= self._t.shape[0], self._fill, out)
        return out if np.ndim(t) else float(out)


def constant(watts: float) -> MutableSource:
    """Convenience: a fixed-power source."""
    return MutableSource(watts)


__all__ = ["PowerSource", "MutableSource", "ModelSource", "TraceSource",
           "TraceExhausted", "constant", "ServePowerModel"]
