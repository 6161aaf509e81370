"""Deterministic replay of recorded ``.dkt`` traces.

Recorded power turns into a regression instrument three ways:

``replay_attribution``  re-drive a recorded serving session window by
                        window: rebuild the session around a ``TraceSource``
                        of the recorded watts (noise-free probe, same report
                        grid, same clock origin), re-raise the recorded
                        tags, and recompute the per-request equal-share
                        energy split. Because the probe pipeline is
                        quantization-idempotent, the replayed stream is
                        bit-equal to the recording and the per-request
                        joules match the live run exactly.
``replay_policy``       drive the serve ``AdmissionController`` (DVFS
                        capping, TTL shed, injectable overrides) through a
                        deterministic tick simulation whose energy comes
                        from the recorded streams — swap policies, diff the
                        resulting ``PolicyResult`` rows.
``replay_cluster``      feed the recorded per-node power into
                        ``ClusterManager.submit``/``advance`` so scheduler
                        and quota experiments debit *measured* joules
                        instead of TDP guesses.

Everything is a pure function of (trace bytes, workload, policy): no wall
clock, no RNG — the same trace yields the same ``ReplayReport`` every time.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster.manager import ClusterManager
from repro_torch.cluster.topology import Topology
from repro_torch.core.probe import ProbeConfig
from repro_torch.obs import coerce_event
from repro_torch.core.scheduler import ThroughputStats
from repro_torch.serve.queue import AdmissionController
from repro_torch.telemetry import MonitorSession, SampleBlock, TraceSource
from repro_torch.tracestore.io import TraceReader


# ---------------------------------------------------------------------------
# typed results


@dataclasses.dataclass(frozen=True)
class PolicyResult:
    """One admission policy's outcome against one recorded trace."""

    policy: str
    energy_j: float                      # trace energy over the replayed span
    attributed_j: float                  # share landed on requests
    completed: int
    shed: int
    tokens: int
    duration_s: float
    per_request_j: Tuple[Tuple[int, float], ...]   # (req_id, J) sorted
    dvfs_f_ghz: Optional[float] = None

    @property
    def j_per_token(self) -> float:
        return self.attributed_j / self.tokens if self.tokens else 0.0


@dataclasses.dataclass(frozen=True)
class ClusterJobResult:
    job_id: int
    user: str
    state: str
    energy_j: float
    start_t: float
    end_t: float


@dataclasses.dataclass(frozen=True)
class ReplayReport:
    """Typed summary of a replay run (deterministic per trace+workload)."""

    trace_path: str
    n_streams: int
    n_samples: int
    duration_s: float
    results: Tuple[PolicyResult, ...] = ()
    cluster_jobs: Tuple[ClusterJobResult, ...] = ()

    def result(self, policy: str) -> PolicyResult:
        for r in self.results:
            if r.policy == policy:
                return r
        raise KeyError(f"no policy {policy!r} in report")

    def deltas(self, base: str, other: str) -> Dict[str, float]:
        """Deltas of ``other`` relative to ``base`` — the numbers an
        admission-policy regression test asserts on. Keys mirror the
        ``PolicyResult`` fields: ``energy_j`` is the trace energy over each
        policy's replayed span, ``attributed_j`` the share landed on
        requests."""
        a, b = self.result(base), self.result(other)
        return {
            "energy_j": b.energy_j - a.energy_j,
            "attributed_j": b.attributed_j - a.attributed_j,
            "shed": b.shed - a.shed,
            "completed": b.completed - a.completed,
            "j_per_token": b.j_per_token - a.j_per_token,
        }


# ---------------------------------------------------------------------------
# source / session reconstruction (the import hooks)


def rebuild_sources(reader: TraceReader,
                    on_exhausted: str = "raise") -> Dict[str, List[TraceSource]]:
    """Per-node ``TraceSource`` lists, one per recorded stream (chip)."""
    out: Dict[str, List[TraceSource]] = {}
    for s in reader.streams:
        block = reader.read(s["id"])
        out.setdefault(s.get("node", "node"), []).append(
            TraceSource.from_block(block, on_exhausted=on_exhausted))
    return out


def node_power_fn(reader: TraceReader, node: str,
                  on_exhausted: str = "hold",
                  sources: Optional[Dict[str, List[TraceSource]]] = None
                  ) -> Callable:
    """power(t) summing the node's recorded chip streams (cluster replay).
    Pass a prebuilt ``rebuild_sources`` map when calling per node — each
    default call decodes the whole file."""
    srcs = (sources if sources is not None
            else rebuild_sources(reader, on_exhausted)).get(node)
    if not srcs:
        raise KeyError(f"no streams recorded for node {node!r}")
    return lambda t: float(sum(s(t) for s in srcs))


class WindowedTraceSource:
    """Replays one recorded sampling window at a time (``ModelSource``
    style: the host installs the next window before each ``sample`` call).

    A single whole-stream zero-order hold is *not* bit-exact at window
    boundaries: the session's grid carry can leave consecutive windows
    overlapping by less than the probe's raw averaging span (AVG_N/RAW_SPS
    = 0.75 ms), so a report near a boundary would average in the previous
    window's last value. Scoping the hold to the current window's reports
    makes every averaged report reproduce its recorded value exactly.
    """

    def __init__(self):
        self._trace: Optional[TraceSource] = None

    def set_window(self, block: SampleBlock):
        self._trace = (TraceSource.from_block(block, on_exhausted="hold")
                       if block.n else None)

    def __call__(self, t):
        if self._trace is None:
            return np.zeros(np.shape(t)) if np.ndim(t) else 0.0
        return self._trace(t)


def replay_session(reader: TraceReader, stream_id: Optional[int] = None,
                   source=None) -> MonitorSession:
    """Rebuild a ``MonitorSession`` around a recorded stream: noise-free,
    unclipped probe at the recorded volts, the recorded report grid, and
    the recorded clock origin. Default source is a whole-stream
    ``TraceSource``; pass ``source`` (e.g. a :class:`WindowedTraceSource`)
    to control replay granularity.

    The recorded reports have passed the live probe's USB-PD clip already,
    and its noise, added after the clip, can leave a report a few mW above
    the limit. Clipping again would lower those reports, so the replayed
    probe has no limit (the reference's keeps the 240 W one and is exact
    only below it)."""
    sid = stream_id if stream_id is not None else reader.stream_ids()[0]
    s = reader.stream(sid)
    if source is None:
        source = TraceSource.from_block(reader.read(sid), on_exhausted="raise")
    cfg = ProbeConfig(noise_w=0.0, volts_nominal=s.get("volts", 20.0),
                      max_watts=float("inf"))
    return MonitorSession(source, node=s.get("node", "replay"),
                          clock_t0=reader.meta.get("clock_t0", 0.0),
                          probe_cfg=cfg,
                          grid_sps=reader.meta.get("grid_sps",
                                                   s.get("sps", 1000.0)))


def replay_attribution(reader: TraceReader,
                       stream_id: Optional[int] = None) -> Dict[int, float]:
    """Recompute per-request energy attribution from a recorded serving
    session (``recorder.record_engine``): replay every logged telemetry
    event (phase, wall seconds, slot-tag -> request ids) through a rebuilt
    session — window by window against the recorded power — and split each
    window's energy exactly as the live engine did. The replayed stream is
    bit-equal to the recording (quantization-idempotent probe pipeline), so
    the returned {req_id: joules} reproduces the live attribution exactly.
    """
    events = [coerce_event(e) for e in reader.meta.get("events", [])]
    if not events:
        raise ValueError(
            f"{reader.path} has no telemetry event log — record the run "
            f"with tracestore.recorder.record_engine")
    sid = stream_id if stream_id is not None else reader.stream_ids()[0]
    source = WindowedTraceSource()
    session = replay_session(reader, sid, source=source)
    windows = reader.blocks(sid)
    per_req: Dict[int, float] = {}
    for ev in events:
        groups = ev.groups
        source.set_window(next(windows, SampleBlock.empty()))
        block = session.sample(ev.wall_s,
                               tags=[ev.phase] + sorted(groups))
        per_tag = block.split_energy({tg: len(ids)
                                      for tg, ids in groups.items()})
        for tg, ids in groups.items():
            share = per_tag.get(tg, 0.0) / len(ids)
            if share:
                for rid in ids:
                    per_req[rid] = per_req.get(rid, 0.0) + share
    return per_req


# ---------------------------------------------------------------------------
# policy replay (admission control against recorded power)


@dataclasses.dataclass
class ReplayRequest:
    """A workload row for policy replay (no token ids — the model does not
    rerun; only admission, occupancy, and energy attribution do)."""

    req_id: int
    max_new_tokens: int = 16
    ttl_s: Optional[float] = None
    arrival_s: float = 0.0
    prompt_tokens: int = 0       # prefill cost in the shed walk (live parity)
    # filled by the simulation
    n_generated: int = 0
    energy_j: float = 0.0
    done: bool = False
    finish_reason: str = ""


class EnergyTimeline:
    """Cumulative-energy index over recorded streams: O(log n) exact
    integral of recorded power over any [a, b) window. Build once per
    trace and share across policy replays — construction decodes and
    sorts every selected stream."""

    def __init__(self, blocks: Sequence[SampleBlock]):
        ts, es = [], []
        for b in blocks:
            if b.n:
                ts.append(np.asarray(b.t))
                es.append(np.asarray(b.watts) * np.asarray(b.dt))
        if ts:
            t = np.concatenate(ts)
            e = np.concatenate(es)
            order = np.argsort(t, kind="stable")
            self._t = t[order]
            self._cum = np.concatenate([[0.0], np.cumsum(e[order])])
        else:
            self._t = np.zeros(0)
            self._cum = np.zeros(1)
        self.total_j = float(self._cum[-1])
        self.t_end = float(self._t[-1]) if self._t.shape[0] else 0.0

    def window_j(self, a: float, b: float) -> float:
        """Energy of reports with timestamp in (a, b]."""
        lo = int(np.searchsorted(self._t, a, side="right"))
        hi = int(np.searchsorted(self._t, b, side="right"))
        return float(self._cum[hi] - self._cum[lo])


def replay_policy(reader: TraceReader, workload: Sequence[ReplayRequest],
                  admission: Optional[AdmissionController] = None,
                  name: str = "baseline", *, batch_size: int = 4,
                  step_s: float = 0.01, node: Optional[str] = None,
                  tokens_per_step: int = 1,
                  timeline: Optional[EnergyTimeline] = None) -> PolicyResult:
    """Deterministic tick simulation of the admission pipeline against a
    recorded trace.

    Each ``step_s`` tick: arrivals join the queue, the TTL shed walk runs
    (mirroring ``ContinuousEngine._shed_stale``), free slots admit under
    the policy, every active request generates ``tokens_per_step`` tokens,
    and the tick's *recorded* energy is split equally among active
    requests. Throughput statistics are fed from the simulated token flow,
    so ``should_shed`` sees the same signal shape as the live engine —
    minus the wall-clock jitter.
    """
    adm = admission or AdmissionController(stats=ThroughputStats())
    if timeline is None:
        streams = [s["id"] for s in reader.streams
                   if node is None or s.get("node") == node]
        timeline = EnergyTimeline([reader.read(sid) for sid in streams])
    dvfs = adm.apply_dvfs(batch_size)
    reqs = [dataclasses.replace(r, n_generated=0, energy_j=0.0, done=False,
                                finish_reason="")
            for r in sorted(workload, key=lambda r: (r.arrival_s, r.req_id))]
    queue: List[ReplayRequest] = []
    active: List[ReplayRequest] = []
    pending = list(reqs)
    t, shed, tokens = 0.0, 0, 0
    while (pending or queue or active) and t < timeline.t_end + step_s:
        while pending and pending[0].arrival_s <= t:
            queue.append(pending.pop(0))
        # TTL shed walk (same order + ahead accounting as the live engine:
        # decode budgets and queued prompt tokens tracked separately)
        ahead = sum(r.max_new_tokens - r.n_generated for r in active)
        ahead_prefill = 0
        for r in list(queue):
            # should_shed only reads ttl_s, so ReplayRequest passes directly
            if adm.should_shed(r, ahead, ahead_prefill):
                queue.remove(r)
                r.done, r.finish_reason = True, "shed"
                shed += 1
            else:
                ahead += r.max_new_tokens
                ahead_prefill += r.prompt_tokens
        while queue and len(active) < batch_size and \
                adm.admit(len(active), batch_size):
            active.append(queue.pop(0))
        if active:
            e = timeline.window_j(t, t + step_s) / len(active)
            n_gen = len(active) * tokens_per_step
            adm.stats.observe("decode", n_gen, step_s)
            tokens += n_gen
            for r in list(active):
                r.energy_j += e
                r.n_generated += tokens_per_step
                if r.n_generated >= r.max_new_tokens:
                    r.done, r.finish_reason = True, "length"
                    active.remove(r)
        t += step_s
    return PolicyResult(
        policy=name,
        energy_j=timeline.window_j(0.0, t),
        attributed_j=sum(r.energy_j for r in reqs),
        completed=sum(r.finish_reason == "length" for r in reqs),
        shed=shed, tokens=tokens, duration_s=t,
        per_request_j=tuple(sorted((r.req_id, r.energy_j) for r in reqs)),
        dvfs_f_ghz=dvfs.f_ghz if dvfs else None)


# ---------------------------------------------------------------------------
# cluster replay (recorded power through the resource manager)


def replay_cluster(reader: TraceReader, topo: Topology,
                   jobs: Sequence[Dict], step_s: float = 1.0,
                   idle_off_s: float = 600.0) -> Tuple[ClusterJobResult, ...]:
    """Run a job schedule through ``ClusterManager`` with each job's power
    model reading the recorded node traces (ZOH at the manager's event
    clock) — quotas and job energy debit measured joules.

    ``jobs`` rows: {user, partition, n_nodes, duration_s, submit_s}.
    """
    mgr = ClusterManager(topo, idle_off_s=idle_off_s)
    recorded = rebuild_sources(reader, "hold")      # one decode, all nodes
    fns = {name: node_power_fn(reader, name, sources=recorded)
           for name in topo.nodes if name in recorded}

    def power_model(node: str) -> float:
        fn = fns.get(node)
        return fn(mgr.elastic.t) if fn else 0.0

    t_end = max((reader.time_range(s["id"])[1] for s in reader.streams),
                default=0.0)
    schedule = sorted(jobs, key=lambda j: j.get("submit_s", 0.0))
    submitted = []
    for spec in schedule:
        t_sub = float(spec.get("submit_s", 0.0))
        if t_sub > mgr.elastic.t:
            mgr.advance(t_sub - mgr.elastic.t)
        submitted.append(mgr.submit(
            spec["user"], spec["partition"], int(spec["n_nodes"]),
            float(spec["duration_s"]), power_model))
    horizon = max(t_end, max((j.end_t for j in submitted), default=0.0))
    if horizon > mgr.elastic.t:
        mgr.advance(horizon - mgr.elastic.t + step_s)
    return tuple(ClusterJobResult(j.job_id, j.user, j.state, j.energy_j,
                                  j.start_t, j.end_t)
                 for j in submitted)


# ---------------------------------------------------------------------------
# one-call harness


def replay(path, workload: Optional[Sequence[ReplayRequest]] = None,
           policies: Optional[Dict[str, AdmissionController]] = None,
           *, batch_size: int = 4, step_s: float = 0.01,
           node: Optional[str] = None, topo: Optional[Topology] = None,
           cluster_jobs: Optional[Sequence[Dict]] = None) -> ReplayReport:
    """Load a trace and replay the given policies (and, optionally, a
    cluster job schedule) against it."""
    with TraceReader(path) as reader:
        duration = max((reader.time_range(s["id"])[1]
                        for s in reader.streams), default=0.0)
        results = []
        if workload is not None:
            streams = [s["id"] for s in reader.streams
                       if node is None or s.get("node") == node]
            timeline = EnergyTimeline([reader.read(sid) for sid in streams])
            for pname, adm in (policies or
                               {"baseline": None}).items():
                results.append(replay_policy(
                    reader, workload, adm, name=pname,
                    batch_size=batch_size, step_s=step_s, node=node,
                    timeline=timeline))
        jobs = ()
        if topo is not None and cluster_jobs:
            jobs = replay_cluster(reader, topo, cluster_jobs)
        return ReplayReport(
            trace_path=reader.path, n_streams=len(reader.streams),
            n_samples=reader.n_samples(), duration_s=duration,
            results=tuple(results), cluster_jobs=jobs)
