"""Energy-aware heterogeneous scheduling (paper Sec. 6.1).

Two use cases from the paper, generalized into framework features:

1. *Two-resource-type task scheduling* (Orhan et al., HCW'25, extended by
   Idouar et al. with real DALEK power readings): partially-replicable task
   chains placed across two core/device classes, optimizing makespan or
   energy. We implement the list-scheduling variant with an
   energy-aware objective.

2. *Straggler mitigation for heterogeneous data parallelism*: when
   partitions differ in throughput (p-cores vs e-cores; old vs new pods),
   static equal sharding makes the slowest partition the critical path.
   The scheduler splits work proportionally to measured throughput and
   re-balances online from telemetry (the paper's probes close this loop).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.energy import power_w
from repro_torch.core.hw import DeviceSpec


@dataclasses.dataclass(frozen=True)
class Task:
    """One unit of a task chain. flops and replicable span (HCW'25 model)."""

    name: str
    flops: float
    replicable: bool = True      # can split across devices of one class
    deps: Tuple[str, ...] = ()


@dataclasses.dataclass(frozen=True)
class ResourceClass:
    """One device class (p-cores / e-cores; 4090s / iGPUs; pod A / pod B)."""

    name: str
    dev: DeviceSpec
    count: int
    efficiency: float = 1.0       # achievable fraction of peak


@dataclasses.dataclass
class Placement:
    task: str
    resource: str
    start_s: float
    end_s: float
    energy_j: float


class HeterogeneousScheduler:
    """List scheduler over two (or more) resource classes.

    objective: "time" (makespan), "energy" (J), or "edp" (energy-delay
    product) — the trade-off the DALEK energy platform makes measurable.
    """

    def __init__(self, classes: Sequence[ResourceClass], objective="time"):
        self.classes = list(classes)
        self.objective = objective

    def _exec_time(self, task: Task, rc: ResourceClass) -> float:
        rate = rc.dev.peak_flops * rc.efficiency
        if task.replicable:
            rate *= rc.count
        return task.flops / rate

    def _energy(self, task: Task, rc: ResourceClass, t: float) -> float:
        n = rc.count if task.replicable else 1
        return power_w(rc.dev, util=1.0) * n * t

    def _score(self, t: float, e: float) -> float:
        if self.objective == "time":
            return t
        if self.objective == "energy":
            return e
        return t * e  # edp

    def schedule(self, tasks: Sequence[Task]) -> Tuple[List[Placement], Dict]:
        """Greedy earliest-finish list scheduling with the chosen objective."""
        ready_at = {rc.name: 0.0 for rc in self.classes}
        done_at: Dict[str, float] = {}
        placements: List[Placement] = []
        pending = list(tasks)
        scheduled = set()
        while pending:
            progressed = False
            for task in list(pending):
                if any(d not in done_at for d in task.deps):
                    continue
                dep_ready = max([done_at[d] for d in task.deps], default=0.0)
                best = None
                for rc in self.classes:
                    t_exec = self._exec_time(task, rc)
                    start = max(ready_at[rc.name], dep_ready)
                    end = start + t_exec
                    e = self._energy(task, rc, t_exec)
                    # score on completion time for deps + objective
                    key = (self._score(end, e), end)
                    if best is None or key < best[0]:
                        best = (key, rc, start, end, e)
                _, rc, start, end, e = best
                placements.append(Placement(task.name, rc.name, start, end, e))
                ready_at[rc.name] = end
                done_at[task.name] = end
                pending.remove(task)
                scheduled.add(task.name)
                progressed = True
            if not progressed:
                raise ValueError("dependency cycle in task chain")
        makespan = max((p.end_s for p in placements), default=0.0)
        energy = sum(p.energy_j for p in placements)
        return placements, {"makespan_s": makespan, "energy_j": energy}


# ---------------------------------------------------------------------------
# straggler mitigation: throughput-proportional work split


@dataclasses.dataclass
class WorkerStats:
    name: str
    tokens_per_s: float           # measured (telemetry) or modeled


def proportional_split(total: int, workers: Sequence[WorkerStats],
                       quantum: int = 1) -> Dict[str, int]:
    """Split ``total`` work items proportionally to throughput, quantized.

    Guarantees: sum == total; every worker >= 0; faster workers never get
    less than slower ones.
    """
    rates = np.array([max(w.tokens_per_s, 1e-9) for w in workers])
    raw = total * rates / rates.sum()
    q = np.floor(raw / quantum).astype(int) * quantum
    rem = total - int(q.sum())
    order = np.argsort(-(raw - q))
    i = 0
    while rem > 0:
        q[order[i % len(workers)]] += min(quantum, rem)
        rem -= min(quantum, rem)
        i += 1
    return {w.name: int(n) for w, n in zip(workers, q)}


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


class StragglerMitigator:
    """Online re-balancer: EWMA throughput per worker, re-split when the
    predicted critical-path gain exceeds a threshold."""

    def __init__(self, workers: Sequence[str], alpha=0.3, threshold=0.05):
        self.rates = {w: 0.0 for w in workers}
        self.alpha = alpha
        self.threshold = threshold
        self.resplits = 0

    def observe(self, worker: str, items: int, seconds: float):
        r = items / max(seconds, 1e-9)
        old = self.rates[worker]
        self.rates[worker] = r if old == 0 else (
            self.alpha * r + (1 - self.alpha) * old)

    def current_split(self, total: int, quantum: int = 1) -> Dict[str, int]:
        ws = [WorkerStats(n, r if r > 0 else 1.0)
              for n, r in self.rates.items()]
        return proportional_split(total, ws, quantum)

    def should_resplit(self, current: Dict[str, int]) -> bool:
        """True when the balanced split beats the current one by >threshold."""
        if any(r == 0 for r in self.rates.values()):
            return False
        total = sum(current.values())
        t_now = max(current[w] / self.rates[w] for w in current)
        bal = self.current_split(total)
        t_bal = max(bal[w] / self.rates[w] for w in bal)
        gain = (t_now - t_bal) / max(t_now, 1e-9)
        if gain > self.threshold:
            self.resplits += 1
            return True
        return False
