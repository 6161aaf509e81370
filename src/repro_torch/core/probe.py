"""INA228-probe model (paper Sec. 4.2).

A probe sits between the supply and the node, samples V/I at 4000 SPS, and
reports 4-sample averages (1000 SPS) with milliwatt resolution. The paper
trades the INA228's max 10000 SPS down to 4000 SPS for resolution; we model
exactly the reported configuration: each emitted sample carries the averaged
voltage, current, power, and the number of raw measurements averaged.

The probe is *driven* by a power model (``power_fn(t) -> W``): in deployment
that is the physical node; here it is the simulated node power trace (DVFS
model x utilization), which lets every energy experiment in the paper run
bit-faithfully on this cluster-less container.

Two read paths share one arithmetic pipeline (clip -> noise -> floor ->
average -> mW quantize), so they agree bit-for-bit:

``Probe.read``        per-object ``Sample`` list (legacy hosts/tests);
``Probe.read_block``  columnar ``(t, watts)`` arrays — the default under
                      ``repro_torch.telemetry`` — evaluating the power function on
                      whole timestamp arrays when it supports that.

Both accept a report rate ``sps`` below ``REPORT_SPS``: an oversubscribed
I2C bus ships fewer reports per probe (decimation), so the averaging window
of each surviving report stays the INA228's 4-raw-sample configuration while
the stream's integration dt grows to ``1/sps``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

RAW_SPS = 4000          # INA228 configured rate (paper: reduced from 10000)
AVG_N = 4               # samples averaged per report
REPORT_SPS = RAW_SPS // AVG_N   # 1000 SPS
MILLIWATT = 1e-3        # reported resolution
MAX_PD_WATTS = 240.0    # USB PD 3.1 probe limit (paper Sec. 4.2)


@dataclasses.dataclass(frozen=True)
class Sample:
    """One averaged report (paper: V, I, P + averaging count)."""

    t: float            # seconds since stream start
    volts: float
    amps: float
    watts: float
    n_avg: int
    tags: tuple = ()    # GPIO tags active when the sample was taken
    dt: float = 1.0 / REPORT_SPS    # this report's integration period


@dataclasses.dataclass
class ProbeConfig:
    probe_id: int = 0
    volts_nominal: float = 20.0      # USB-PD rail
    noise_w: float = 0.005           # measurement noise (W, std)
    max_watts: float = MAX_PD_WATTS
    seed: int = 0


def _eval_power(power_fn: Callable, t: np.ndarray) -> np.ndarray:
    """Evaluate ``power_fn`` over a timestamp array, vectorized when the
    function supports arrays. Scalar-only functions (TypeError/ValueError
    on array input, or a scalar result) fall back to a per-element loop;
    any other exception is a real bug in the power function and propagates."""
    try:
        w = np.asarray(power_fn(t), dtype=np.float64)
    except (TypeError, ValueError):
        w = None
    if w is not None and w.shape == t.shape:
        return w
    if w is not None and w.shape == ():
        return np.full(t.shape, float(w))
    return np.fromiter((float(power_fn(x)) for x in t), np.float64,
                       count=t.size).reshape(t.shape)


def _report_grid(t0: float, duration: float,
                 sps: float) -> Tuple[np.ndarray, np.ndarray]:
    """(report timestamps [n], raw timestamps [n, AVG_N]) for a read.

    Reports land at ``t0 + (i+1)/sps``; each averages the AVG_N raw
    conversions immediately preceding it at RAW_SPS spacing (at full rate
    this is exactly the contiguous 4000 SPS raw stream)."""
    n = int(round(duration * sps))
    t_rep = t0 + (np.arange(n, dtype=np.float64) + 1) / sps
    offs = (np.arange(AVG_N, dtype=np.float64) - (AVG_N - 1)) / RAW_SPS
    return t_rep, t_rep[:, None] + offs[None, :]


def _pipeline(raw_w: np.ndarray, cfg: ProbeConfig,
              rng: np.random.Generator) -> np.ndarray:
    """clip -> noise -> floor -> average -> mW quantize (shared by all
    read paths; identical arithmetic order keeps them bit-equal)."""
    w = np.clip(raw_w, 0.0, cfg.max_watts)
    w = np.maximum(w + rng.normal(0.0, cfg.noise_w, w.shape), 0.0)
    watts = w.mean(axis=-1)
    return np.round(watts / MILLIWATT) * MILLIWATT


class Probe:
    """Streams averaged samples from a power function."""

    def __init__(self, power_fn: Callable[[float], float],
                 cfg: Optional[ProbeConfig] = None):
        self.power_fn = power_fn
        self.cfg = cfg or ProbeConfig()
        self._rng = np.random.default_rng(self.cfg.seed + self.cfg.probe_id)

    def read_block(self, t0: float, duration: float,
                   sps: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Columnar read: ``(t [n], watts [n])`` at ``sps`` reports/s
        (default ``REPORT_SPS``) in (t0, t0+duration]."""
        cfg = self.cfg
        t_rep, t_raw = _report_grid(t0, duration, sps or REPORT_SPS)
        raw_w = _eval_power(self.power_fn, t_raw.ravel()).reshape(t_raw.shape)
        return t_rep, _pipeline(raw_w, cfg, self._rng)

    def read(self, t0: float, duration: float,
             sps: Optional[float] = None) -> List[Sample]:
        """Samples in (t0, t0+duration] as ``Sample`` objects, carrying the
        stream's actual report period (``1/sps``) for energy integration."""
        cfg = self.cfg
        t_rep, watts = self.read_block(t0, duration, sps)
        volts = cfg.volts_nominal
        dt = 1.0 / (sps or REPORT_SPS)
        return [Sample(float(t), volts,
                       round(float(w) / volts, 6) if volts else 0.0,
                       float(w), AVG_N, dt=dt)
                for t, w in zip(t_rep, watts)]


def read_vectorized(power_fn, t0: float, duration: float,
                    cfg: Optional[ProbeConfig] = None,
                    sps: Optional[float] = None) -> np.ndarray:
    """Vectorized one-shot read (fresh rng from the config seed): returns
    [n, 2] (t, watts). ``Probe.read_block`` is the stateful equivalent."""
    cfg = cfg or ProbeConfig()
    rng = np.random.default_rng(cfg.seed + cfg.probe_id)
    t_rep, t_raw = _report_grid(t0, duration, sps or REPORT_SPS)
    raw_w = _eval_power(power_fn, t_raw.ravel()).reshape(t_raw.shape)
    return np.stack([t_rep, _pipeline(raw_w, cfg, rng)], axis=1)
