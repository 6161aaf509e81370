"""Main-board aggregator (paper Sec. 4.1).

One PIC18-based board per node: two I2C connectors, up to six probes
daisy-chained per connector (12 max), 5 V USB power + data. The I2C bus is
the bottleneck: the bus budget is ``PROBES_PER_BUS * REPORT_SPS`` report
slots per second, so six probes sustain the full 1000 SPS each and an
oversubscribed chain (``attach(..., oversubscribe=True)`` past the paper's
recommended six) degrades every probe on that bus proportionally
(``effective_sps``). Eight GPIO inputs tag samples with code regions.

We model the board faithfully: bus budget enforcement, per-probe report
streams at their degraded rates, tag annotation at sample timestamps, and a
host-side API mirroring the planned C API (paper Sec. 4.3):

``read_samples``  legacy per-object ``Sample`` lists;
``read_block``    columnar ``repro_torch.telemetry.samples.SampleBlock`` per probe
                  (the default path under ``repro_torch.telemetry``).

Energy integration uses each stream's actual report period — not a
hardcoded ``1/REPORT_SPS`` — so oversubscribed streams integrate correctly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.probe import REPORT_SPS, Probe, Sample
from repro_torch.core.tags import TagBus

N_I2C_BUSES = 2
PROBES_PER_BUS = 6
MAX_PROBES = N_I2C_BUSES * PROBES_PER_BUS
BUS_MAX_SPS = PROBES_PER_BUS * REPORT_SPS   # paper: 1000 SPS with 6 probes


class MainBoard:
    """Aggregates probes over two I2C buses; attaches GPIO tags to samples."""

    def __init__(self, node_name: str = "node", clock_t0: float = 0.0):
        self.node_name = node_name
        self._buses: List[List[Probe]] = [[], []]
        self._tags = TagBus(clock=self._now)
        self._t = clock_t0

    # -- virtual clock (simulation time) ------------------------------------

    def _now(self) -> float:
        return self._t

    def advance(self, dt: float):
        self._t += dt

    @property
    def now(self) -> float:
        return self._t

    @property
    def tags(self) -> TagBus:
        return self._tags

    # -- probe management ----------------------------------------------------

    def attach(self, probe: Probe, bus: Optional[int] = None,
               oversubscribe: bool = False) -> int:
        """Attach a probe; ``oversubscribe=True`` allows daisy-chaining past
        the paper's six-per-connector recommendation, trading per-probe
        report rate (I2C budget is shared — see ``effective_sps``)."""
        if bus is None:
            bus = 0 if len(self._buses[0]) <= len(self._buses[1]) else 1
        if not 0 <= bus < N_I2C_BUSES:
            raise ValueError(f"bus {bus} out of range")
        if len(self._buses[bus]) >= PROBES_PER_BUS and not oversubscribe:
            raise RuntimeError(
                f"I2C bus {bus} full ({PROBES_PER_BUS} probes max — paper HW limit)")
        self._buses[bus].append(probe)
        return bus

    @property
    def n_probes(self) -> int:
        return sum(len(b) for b in self._buses)

    def effective_sps(self, bus: int) -> float:
        """Per-probe report rate on a bus (I2C budget shared)."""
        n = len(self._buses[bus])
        if n == 0:
            return 0.0
        return min(REPORT_SPS, BUS_MAX_SPS / n)

    def probes(self) -> List[tuple]:
        """(probe_id, bus, probe, effective_sps) rows in stream order."""
        out, pid = [], 0
        for b, bus in enumerate(self._buses):
            sps = self.effective_sps(b)
            for probe in bus:
                out.append((pid, b, probe, sps))
                pid += 1
        return out

    # -- sampling ------------------------------------------------------------

    def read_samples(self, duration: float) -> Dict[int, List[Sample]]:
        """Advance time by ``duration`` and return per-probe samples with
        the GPIO tags that were active at each sample timestamp. Each probe
        reports at its bus's ``effective_sps``."""
        t0 = self._t
        out: Dict[int, List[Sample]] = {}
        idx = self._tags.index()
        for pid, _, probe, sps in self.probes():
            samples = probe.read(t0, duration, sps=sps)
            out[pid] = [dataclasses.replace(s, tags=idx.active_at(s.t))
                        for s in samples]
        self._t = t0 + duration
        return out

    def read_block(self, duration: float) -> Dict[int, "SampleBlock"]:
        """Columnar read: per-probe ``SampleBlock`` (numpy columns + GPIO
        bitmask) — the fast path ``repro_torch.telemetry`` routes through."""
        from repro_torch.telemetry.samples import read_board_blocks
        return read_board_blocks(self, duration)

    # -- energy accounting ---------------------------------------------------

    @staticmethod
    def energy_j(samples: List[Sample], dt: Optional[float] = None) -> float:
        """Samples are averaged power over fixed report intervals: energy is
        each report's power times its actual integration period (``s.dt``,
        set by the read path from the stream's effective rate); pass ``dt``
        to override."""
        if dt is not None:
            return sum(s.watts for s in samples) * dt
        return sum(s.watts * s.dt for s in samples)

    @staticmethod
    def energy_by_tag(samples: List[Sample],
                      dt: Optional[float] = None) -> Dict[str, float]:
        """Per-tag energy attribution (paper Sec. 4.1: GPIO-synchronized
        fine-grained profiling)."""
        out: Dict[str, float] = {}
        for s in samples:
            for tag in s.tags:
                out[tag] = out.get(tag, 0.0) + s.watts * (dt if dt is not None
                                                          else s.dt)
        return out
