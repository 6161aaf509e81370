"""SLURM-like resource manager (paper Sec. 3.4/3.5) with the paper's planned
time+energy quotas (Sec. 6.2) implemented.

Semantics reproduced from the paper:
  - salloc/srun/sbatch -> ``submit``: powered-off nodes are woken (WoL),
    jobs start after boot (up to ~2 min);
  - nodes power off after 10 min idle;
  - login policy: access only while holding a reservation (``can_login``);
  - scratch per user, preserved across jobs;
  - MUNGE-style credentials are modeled as opaque tokens;
  - per-user time AND energy quotas, debited from telemetry.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Callable, Dict, List, Optional

from repro_torch.core.elastic import ElasticController, PowerState
from repro_torch.cluster.topology import Topology
from repro_torch.obs import MetricsRegistry


@dataclasses.dataclass
class Quota:
    time_s: float = float("inf")
    energy_j: float = float("inf")
    used_time_s: float = 0.0
    used_energy_j: float = 0.0

    def ok(self) -> bool:
        return (self.used_time_s < self.time_s
                and self.used_energy_j < self.energy_j)


@dataclasses.dataclass
class Job:
    job_id: int
    user: str
    partition: str
    n_nodes: int
    duration_s: float
    power_model: Optional[Callable[[str], float]] = None  # node -> watts
    nodes: List[str] = dataclasses.field(default_factory=list)
    state: str = "PENDING"          # PENDING | CONFIGURING | RUNNING | DONE | FAILED | CANCELLED
    submit_t: float = 0.0
    start_t: float = 0.0
    end_t: float = 0.0
    energy_j: float = 0.0


class ClusterManager:
    """Event-stepped scheduler + power manager over a Topology."""

    def __init__(self, topo: Topology, idle_off_s: float = 600.0,
                 metrics: Optional[MetricsRegistry] = None):
        self.topo = topo
        self.elastic = ElasticController(
            {n: node.spec for n, node in topo.nodes.items()},
            idle_off_s=idle_off_s)
        self.jobs: Dict[int, Job] = {}
        self.quotas: Dict[str, Quota] = {}
        self._ids = itertools.count(1)
        self._creds: Dict[str, str] = {}
        self.scratch: Dict[str, Dict[str, list]] = {}   # node -> user -> files
        # shared observability registry (jobs by state transition, per-user
        # quota energy, live cluster watts) — same store the engines use
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    # -- auth (MUNGE analogue) ------------------------------------------------

    def credential(self, user: str) -> str:
        tok = hashlib.sha256(f"{user}:{self.elastic.t}".encode()).hexdigest()[:16]
        self._creds[tok] = user
        return tok

    def validate(self, token: str) -> Optional[str]:
        return self._creds.get(token)

    # -- quotas (paper Sec. 6.2) ----------------------------------------------

    def set_quota(self, user: str, time_s=float("inf"), energy_j=float("inf")):
        self.quotas[user] = Quota(time_s, energy_j)

    def quota(self, user: str) -> Quota:
        return self.quotas.setdefault(user, Quota())

    # -- job lifecycle ----------------------------------------------------------

    def submit(self, user: str, partition: str, n_nodes: int,
               duration_s: float, power_model=None) -> Job:
        job = Job(next(self._ids), user, partition, n_nodes, duration_s,
                  power_model, submit_t=self.elastic.t)
        self.metrics.counter("cluster_jobs_submitted").inc(user=user)
        if not self.quota(user).ok():
            job.state = "FAILED"
            job.end_t = self.elastic.t
            self.jobs[job.job_id] = job
            self.metrics.counter("cluster_jobs_failed",
                                 "jobs rejected or failed").inc(
                reason="quota")
            return job
        free = [n for n in self.topo.partition_nodes(partition)
                if not self._node_busy(n)]
        if len(free) < n_nodes:
            job.state = "PENDING"
            self.jobs[job.job_id] = job
            return job
        job.nodes = free[:n_nodes]
        ready = self.elastic.resume(job.nodes)   # WoL if powered off
        job.state = "CONFIGURING" if ready > self.elastic.t else "RUNNING"
        job.start_t = ready
        job.end_t = ready + duration_s
        self.jobs[job.job_id] = job
        return job

    def _node_busy(self, name: str) -> bool:
        for j in self.jobs.values():
            if j.state in ("RUNNING", "CONFIGURING") and name in j.nodes:
                return True
        return False

    def cancel(self, job_id: int):
        job = self.jobs[job_id]
        if job.state in ("RUNNING", "CONFIGURING", "PENDING"):
            job.state = "CANCELLED"
            job.end_t = self.elastic.t
            if job.nodes:
                self.elastic.release(job.nodes)

    def advance(self, dt: float):
        """Advance simulation time; finish jobs; debit quotas; start pending."""
        target = self.elastic.t + dt
        while self.elastic.t < target:
            events = [target]
            for j in self.jobs.values():
                if j.state == "CONFIGURING":
                    events.append(j.start_t)
                if j.state in ("RUNNING", "CONFIGURING"):
                    events.append(j.end_t)
            t_next = min(e for e in events if e > self.elastic.t)
            step = t_next - self.elastic.t
            # accumulate job energy over the step
            for j in self.jobs.values():
                if j.state == "RUNNING":
                    for n in j.nodes:
                        w = (j.power_model(n) if j.power_model
                             else self.elastic.nodes[n].spec.tdp_w)
                        j.energy_j += w * step
            self.elastic.advance(step)
            for j in self.jobs.values():
                if j.state == "CONFIGURING" and self.elastic.t >= j.start_t:
                    j.state = "RUNNING"
                    self.elastic.mark_busy(j.nodes)
                if j.state == "RUNNING" and self.elastic.t >= j.end_t:
                    j.state = "DONE"
                    self.elastic.release(j.nodes)
                    q = self.quota(j.user)
                    q.used_time_s += j.end_t - j.start_t
                    q.used_energy_j += j.energy_j
                    self.metrics.counter("cluster_jobs_completed").inc(
                        user=j.user)
                    self.metrics.counter(
                        "cluster_job_energy_j",
                        "measured joules debited to user quotas").inc(
                        j.energy_j, user=j.user)
            self._start_pending()
        self.metrics.gauge("cluster_power_w",
                           "live whole-cluster draw").set(
            self.elastic.total_power_w())

    def _start_pending(self):
        for j in self.jobs.values():
            if j.state != "PENDING":
                continue
            if not self.quota(j.user).ok():
                j.state = "FAILED"
                self.metrics.counter("cluster_jobs_failed",
                                     "jobs rejected or failed").inc(
                    reason="quota")
                continue
            free = [n for n in self.topo.partition_nodes(j.partition)
                    if not self._node_busy(n)]
            if len(free) >= j.n_nodes:
                j.nodes = free[:j.n_nodes]
                ready = self.elastic.resume(j.nodes)
                j.start_t = max(ready, self.elastic.t)
                j.end_t = j.start_t + j.duration_s
                j.state = "CONFIGURING" if j.start_t > self.elastic.t else "RUNNING"
                if j.state == "RUNNING":
                    self.elastic.mark_busy(j.nodes)

    # -- login policy (SPANK/PAM analogue, paper Sec. 3.5) ---------------------

    def can_login(self, user: str, node: str) -> bool:
        for j in self.jobs.values():
            if (j.user == user and j.state == "RUNNING" and node in j.nodes):
                # scratch dir auto-created at first login
                self.scratch.setdefault(node, {}).setdefault(user, [])
                return True
        return False

    def cluster_power_w(self) -> float:
        return self.elastic.total_power_w()
