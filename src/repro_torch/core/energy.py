"""Energy model: J/step and J/token from roofline terms + DVFS.

The paper measures socket power at 1000 SPS; the port *derives* power
from the serving step's roofline terms instead: they give the device's busy
time and utilization, the DVFS model gives power at a frequency, and the
probe/mainboard pipeline replays the resulting trace so every paper
experiment (tagging, averaging, capping) runs identically.

DVFS model (standard cubic): P(f, u) = P_idle + (P_tdp - P_idle) * u * (f/f_max)^3
with throughput proportional to f for compute-bound work and ~flat for
memory-bound work (memory clock is not scaled).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.core.hw import DeviceSpec, H100_SXM


@dataclasses.dataclass(frozen=True)
class DvfsState:
    f_ghz: float

    def rel(self, dev: DeviceSpec) -> float:
        return self.f_ghz / dev.f_max_ghz


STALL_UTIL = 0.35   # utilization while stalled on HBM/ICI (trace stall power)


def power_w(dev: DeviceSpec, util: float, dvfs: Optional[DvfsState] = None) -> float:
    """Instantaneous device power at utilization ``util`` in [0,1]."""
    rel = 1.0 if dvfs is None else dvfs.rel(dev)
    return dev.idle_w + (dev.tdp_w - dev.idle_w) * util * rel ** 3


def busy_fraction(roofline_terms, dvfs: Optional[DvfsState] = None,
                  dev: DeviceSpec = H100_SXM,
                  t_step: Optional[float] = None) -> float:
    """Fraction of a step spent compute-busy (rest stalls at STALL_UTIL).

    The single source of the duty-cycle model shared by the trace
    generators and the admission-control power estimate."""
    t = t_step if t_step is not None else step_time_s(roofline_terms, dvfs, dev)
    if t <= 0:
        return 0.0
    rel = 1.0 if dvfs is None else dvfs.rel(dev)
    return min(roofline_terms["compute"] / max(rel, 1e-6) / t, 1.0)


def step_time_s(roofline_terms: Dict[str, float],
                dvfs: Optional[DvfsState] = None,
                dev: DeviceSpec = H100_SXM,
                overlap: float = 1.0) -> float:
    """Predicted step time from the three roofline terms.

    overlap=1.0: perfect compute/comm overlap (max of terms);
    overlap=0.0: fully serialized (sum of terms).
    Compute scales 1/f; memory and collective terms do not.
    """
    rel = 1.0 if dvfs is None else dvfs.rel(dev)
    c = roofline_terms["compute"] / max(rel, 1e-6)
    m = roofline_terms["memory"]
    x = roofline_terms["collective"]
    t_overlap = max(c, m, x)
    t_serial = c + m + x
    return overlap * t_overlap + (1.0 - overlap) * t_serial


def step_energy_j(roofline_terms: Dict[str, float],
                  dvfs: Optional[DvfsState] = None,
                  dev: DeviceSpec = H100_SXM,
                  overlap: float = 1.0) -> float:
    """Per-chip energy of one step: P(util, f) * t_step."""
    t = step_time_s(roofline_terms, dvfs, dev, overlap)
    rel = 1.0 if dvfs is None else dvfs.rel(dev)
    busy = roofline_terms["compute"] / max(rel, 1e-6)
    util = min(busy / t, 1.0) if t > 0 else 0.0
    return power_w(dev, util, dvfs) * t


def tokens_per_joule(roofline_terms, tokens_per_step, n_chips,
                     dvfs=None, dev=H100_SXM) -> float:
    e = step_energy_j(roofline_terms, dvfs, dev) * n_chips
    return tokens_per_step / e if e else 0.0


def power_trace_fn(roofline_terms, dvfs=None, dev: DeviceSpec = H100_SXM,
                   period_s: Optional[float] = None) -> Callable[[float], float]:
    """power(t) for one chip running repeated steps — drives the probes.

    Within each step the trace is piecewise: compute-bound phase at high
    power, then memory/collective-bound phase at lower power (utilization
    drops while waiting on HBM/ICI).
    """
    t_step = period_s or step_time_s(roofline_terms, dvfs, dev)
    t_busy = busy_fraction(roofline_terms, dvfs, dev, t_step) * t_step

    def fn(t):
        # np.where keeps the trace array-capable: the columnar probe path
        # evaluates whole timestamp windows in one call
        util = np.where(t % t_step < t_busy, 1.0, STALL_UTIL)
        return power_w(dev, util, dvfs)

    return fn


# ---------------------------------------------------------------------------
# serving-phase power model (drives the ServeEngine probes)


def serve_roofline_terms(n_params_active: float, n_tokens: int,
                         dev: DeviceSpec = H100_SXM,
                         param_bytes: Optional[float] = None,
                         cache_bytes: float = 0.0) -> Dict[str, float]:
    """Roofline terms for one serving step processing ``n_tokens``.

    compute: 2·N·tokens matmul FLOPs; memory: one weight (+ cache) reload —
    the decode regime where batch=n_active keeps compute tiny against the
    fixed weight-streaming cost, so power is utilization- and phase-
    dependent rather than a constant.
    """
    pb = param_bytes if param_bytes is not None else 2.0 * n_params_active
    compute = 2.0 * n_params_active * max(n_tokens, 1) / dev.peak_flops
    memory = (pb + cache_bytes) / dev.mem_bw
    return {"compute": compute, "memory": memory, "collective": 0.0}


def scaled_power_trace_fn(roofline_terms, wall_s: float,
                          dvfs: Optional[DvfsState] = None,
                          dev: DeviceSpec = H100_SXM) -> Callable[[float], float]:
    """power(t) over a *measured* wall-clock window.

    The engine may run on any host backend (CPU smoke runs are orders of
    magnitude slower than the modeled deployment chip), so the modeled
    step's busy/stall duty cycle is stretched onto the observed duration:
    average power over the window equals the model's average step power.
    """
    busy_frac = busy_fraction(roofline_terms, dvfs, dev)

    def fn(t):
        phase = (t % wall_s) / wall_s if wall_s > 0 else np.ones_like(t)
        util = np.where(phase < busy_frac, 1.0, STALL_UTIL)
        return power_w(dev, util, dvfs)

    return fn


class ServePowerModel:
    """Phase-aware node power for the serving engine.

    Replaces hardcoded watt constants with traces derived from the
    roofline/DVFS energy model: prefill of S tokens is compute-heavy,
    decode with n active slots is weight-streaming-bound, and an idle
    engine draws ``dev.idle_w``. A DVFS state (e.g. from ``cap_frequency``)
    scales every derived trace.
    """

    def __init__(self, n_params_active: float, dev: DeviceSpec = H100_SXM,
                 param_bytes: Optional[float] = None,
                 dvfs: Optional[DvfsState] = None,
                 cache_bytes: float = 0.0):
        self.n_params = float(n_params_active)
        self.dev = dev
        self.param_bytes = (param_bytes if param_bytes is not None
                            else 2.0 * self.n_params)
        self.dvfs = dvfs
        self.cache_bytes = cache_bytes   # live KV footprint (engine-set)

    def terms(self, n_tokens: int) -> Dict[str, float]:
        return serve_roofline_terms(self.n_params, n_tokens, self.dev,
                                    self.param_bytes, self.cache_bytes)

    def trace(self, n_tokens: int, wall_s: float) -> Callable[[float], float]:
        """power(t) for a step processing ``n_tokens``, stretched to the
        measured ``wall_s`` window (local t starting at 0)."""
        return scaled_power_trace_fn(self.terms(n_tokens), wall_s,
                                     self.dvfs, self.dev)

    def avg_power_w(self, n_tokens: int) -> float:
        """Average power of the derived trace at the current DVFS state
        (duty-cycle-weighted, so it matches what the probes will report)."""
        busy_frac = busy_fraction(self.terms(n_tokens), self.dvfs, self.dev)
        return (busy_frac * power_w(self.dev, 1.0, self.dvfs)
                + (1.0 - busy_frac) * power_w(self.dev, STALL_UTIL, self.dvfs))

    def idle_power_w(self) -> float:
        return self.dev.idle_w


# ---------------------------------------------------------------------------
# power capping (paper Sec. 3.6: RAPL / nvidia-smi power caps)


def cap_frequency(cap_w: float, roofline_terms, dev: DeviceSpec = H100_SXM,
                  n_steps: int = 32) -> DvfsState:
    """Highest frequency whose average step power is within the cap.

    Discrete frequency ladder (like cpufreq governors); returns f_min even
    if the cap is unreachable (can't go below idle).
    """
    for i in range(n_steps, -1, -1):
        f = dev.f_min_ghz + (dev.f_max_ghz - dev.f_min_ghz) * i / n_steps
        st = DvfsState(f)
        t = step_time_s(roofline_terms, st, dev)
        e = step_energy_j(roofline_terms, st, dev)
        if t > 0 and e / t <= cap_w:
            return st
    return DvfsState(dev.f_min_ghz)


def pareto_frontier(roofline_terms, dev: DeviceSpec = H100_SXM, n: int = 16):
    """(f, time, energy) sweep — the energy/performance trade-off the paper's
    DVFS + measurement platform is built to explore."""
    out = []
    for i in range(n + 1):
        f = dev.f_min_ghz + (dev.f_max_ghz - dev.f_min_ghz) * i / n
        st = DvfsState(f)
        out.append({
            "f_ghz": f,
            "step_s": step_time_s(roofline_terms, st, dev),
            "step_j": step_energy_j(roofline_terms, st, dev),
        })
    return out
