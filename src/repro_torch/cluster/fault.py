"""Fault tolerance: failure injection/detection, checkpoint-restart, elastic
re-meshing.

At thousand-node scale the framework must assume node loss is routine. The
contract implemented here:

  - heartbeat-based detection (miss k beats -> dead);
  - training state is periodically checkpointed (atomic, see checkpoint.ckpt);
  - on failure, the run shrinks to the surviving node set: a new (smaller)
    mesh is built, the last committed checkpoint is restored with the new
    shardings, and training resumes (elastic scaling DOWN);
  - recovered/new nodes rejoin at the next checkpoint boundary (scaling UP);
  - DALEK semantics: failed nodes are power-cycled via the elastic
    controller (WoL), with boot latency before rejoin.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class HeartbeatMonitor:
    nodes: Dict[str, float] = dataclasses.field(default_factory=dict)
    interval_s: float = 10.0
    miss_limit: int = 3

    def beat(self, node: str, t: float):
        self.nodes[node] = t

    def dead(self, t: float) -> List[str]:
        limit = self.interval_s * self.miss_limit
        return [n for n, last in self.nodes.items() if t - last > limit]

    def alive(self, t: float) -> List[str]:
        limit = self.interval_s * self.miss_limit
        return [n for n, last in self.nodes.items() if t - last <= limit]


@dataclasses.dataclass
class FailureInjector:
    """Deterministic failure schedule for tests/simulation: MTBF model."""

    mtbf_s: float
    seed: int = 0

    def schedule(self, nodes: Sequence[str], horizon_s: float) -> List[tuple]:
        rng = np.random.default_rng(self.seed)
        events = []
        for n in nodes:
            t = float(rng.exponential(self.mtbf_s))
            while t < horizon_s:
                events.append((t, n))
                t += float(rng.exponential(self.mtbf_s))
        return sorted(events)


@dataclasses.dataclass
class ElasticRunState:
    """What the orchestrator tracks for one elastic training run."""

    step: int = 0
    n_workers: int = 0
    restarts: int = 0
    lost_steps: int = 0
    events: List[dict] = dataclasses.field(default_factory=list)


class ElasticTrainOrchestrator:
    """Drives an elastic training run against failures.

    Pluggable callbacks keep it testable and backend-agnostic:
      build(n_workers)            -> opaque 'session' (mesh+jit+state)
      restore(session, ckpt_step) -> start_step
      train_chunk(session, start, n) -> last_completed_step
      save(session, step)         -> None  (atomic commit)
    """

    def __init__(self, *, build, restore, train_chunk, save,
                 ckpt_every: int = 50, min_workers: int = 1):
        self.build = build
        self.restore = restore
        self.train_chunk = train_chunk
        self.save = save
        self.ckpt_every = ckpt_every
        self.min_workers = min_workers
        self.state = ElasticRunState()

    def run(self, total_steps: int, initial_workers: int,
            failure_events: Optional[List[tuple]] = None,
            step_time_s: float = 1.0):
        """Simulated-time elastic run; failure_events: [(t_s, node_idx)]."""
        st = self.state
        st.n_workers = initial_workers
        failure_events = sorted(failure_events or [])
        fe_i = 0
        t = 0.0
        session = self.build(st.n_workers)
        last_ckpt = 0
        step = self.restore(session, None)
        st.step = step
        while st.step < total_steps:
            chunk = min(self.ckpt_every - (st.step % self.ckpt_every) or
                        self.ckpt_every, total_steps - st.step)
            chunk_end_t = t + chunk * step_time_s
            # does a failure land inside this chunk?
            if (fe_i < len(failure_events)
                    and failure_events[fe_i][0] < chunk_end_t
                    and st.n_workers - 1 >= self.min_workers):
                ft, _node = failure_events[fe_i]
                fe_i += 1
                done = int((ft - t) / step_time_s)
                st.lost_steps += st.step + done - last_ckpt
                st.events.append({"t": ft, "kind": "failure",
                                  "workers": st.n_workers - 1})
                # shrink, rebuild, restore from last commit
                st.n_workers -= 1
                st.restarts += 1
                session = self.build(st.n_workers)
                st.step = self.restore(session, last_ckpt)
                t = ft
                continue
            st.step = self.train_chunk(session, st.step, chunk)
            t = chunk_end_t
            self.save(session, st.step)
            last_ckpt = st.step
            st.events.append({"t": t, "kind": "ckpt", "step": st.step})
        return st
