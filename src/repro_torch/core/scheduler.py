"""Serving throughput statistics (the scheduler's EWMA throughput
loop, keyed by phase) feeding the admission policy."""
from __future__ import annotations

from typing import Dict


class ThroughputStats:
    """EWMA throughput per phase (items/s) from engine telemetry.

    Closes the probe->scheduler loop for serving: the admission policy asks
    for the measured decode rate to predict queue wait and decide whether to
    defer or shed load (same EWMA as ``StragglerMitigator``, keyed by phase
    instead of worker).
    """

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self.rates: Dict[str, float] = {}
        self.totals: Dict[str, float] = {}

    def observe(self, phase: str, items: float, seconds: float):
        r = items / max(seconds, 1e-9)
        old = self.rates.get(phase, 0.0)
        self.rates[phase] = r if old == 0.0 else (
            self.alpha * r + (1 - self.alpha) * old)
        self.totals[phase] = self.totals.get(phase, 0.0) + items

    def rate(self, phase: str, default: float = 0.0) -> float:
        return self.rates.get(phase, default)

    def predicted_wait_s(self, n_items: float, phase: str = "decode") -> float:
        """Time to clear ``n_items`` at the measured rate; inf if unmeasured."""
        r = self.rate(phase)
        return n_items / r if r > 0 else float("inf")
