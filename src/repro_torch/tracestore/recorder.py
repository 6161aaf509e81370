"""Recording sessions into ``.dkt`` traces.

Two entry points:

``ClusterRecorder``        multi-node: one ``MonitorSession`` per
                           ``cluster.topology.Node`` with one probe per
                           chip (``NodeSpec.devices``), all on a shared
                           session clock; every sampling window drains each
                           node's per-probe streams into one multi-stream
                           trace file. Probe chains honor the main board's
                           I2C budget: nodes with more chips than the
                           paper's six-per-connector recommendation attach
                           oversubscribed, and each stream's *effective*
                           report rate is persisted with it.
``record_session`` /       single-node: export an existing session's
``record_engine``          accumulated blocks (e.g. a live serving run,
                           window boundaries intact) plus the engine's
                           telemetry event log, so the run can be replayed
                           deterministically offline.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.cluster.topology import Node, Topology
from repro_torch.core.probe import REPORT_SPS, ProbeConfig
from repro_torch.obs import events_to_meta
from repro_torch.telemetry import MonitorSession, MutableSource
from repro_torch.tracestore.io import TraceWriter

SourceFactory = Callable[[Node, object], object]   # (node, chip) -> PowerSource


def _idle_sources(node: Node, dev) -> MutableSource:
    """Default factory: each chip starts at its idle draw; the host updates
    it (``ClusterRecorder.set_power``) as the workload runs."""
    return MutableSource(dev.idle_w)


class ClusterRecorder:
    """Records every node of a topology into one multi-stream trace."""

    def __init__(self, topo: Topology, path,
                 nodes: Optional[Sequence[str]] = None,
                 source_factory: SourceFactory = _idle_sources,
                 grid_sps: float = REPORT_SPS, clock_t0: float = 0.0,
                 probe_cfg: Optional[ProbeConfig] = None,
                 meta: Optional[Dict] = None):
        names = list(nodes) if nodes is not None else sorted(topo.nodes)
        missing = [n for n in names if n not in topo.nodes]
        if missing:
            raise KeyError(f"nodes not in topology: {missing}")
        self.sessions: Dict[str, MonitorSession] = {}
        self.sources: Dict[str, List] = {}
        self._streams: Dict[str, Dict[int, int]] = {}   # node -> pid -> sid
        self.writer = TraceWriter(path, meta=dict(meta or {}))
        self.writer.meta.update({
            "kind": "cluster", "clock_t0": clock_t0, "grid_sps": grid_sps,
            "nodes": names,
        })
        for name in names:
            node = topo.nodes[name]
            chips = list(node.spec.devices)
            srcs = [source_factory(node, dev) for dev in chips]
            by_src = {id(s): i for i, s in enumerate(srcs)}
            # one probe per chip on the node's mesh position; chains past
            # the six-per-connector I2C recommendation degrade per-probe
            # rate instead of refusing (oversubscribe)
            sess = MonitorSession(srcs, node=name, clock_t0=clock_t0,
                                  probe_cfg=probe_cfg, grid_sps=grid_sps,
                                  oversubscribe=True)
            self.sessions[name] = sess
            self.sources[name] = srcs
            self._streams[name] = {}
            for pid, bus, src, sps, volts in sess.probe_rows():
                chip_i = by_src[id(src)]
                dev = chips[chip_i]
                sid = self.writer.add_stream(
                    f"{name}/chip{chip_i}", node=name, chip=chip_i,
                    device=dev.name, probe_id=pid, bus=bus, sps=sps,
                    volts=volts, partition=node.partition)
                self._streams[name][pid] = sid
        self._closed = False

    # -- host-side power updates --------------------------------------------

    def set_power(self, node: str, watts) -> None:
        """Update a node's chip power(s) before the next window: a scalar
        applies to every chip, a sequence maps per chip. Only meaningful
        for ``MutableSource``-backed recorders."""
        srcs = self.sources[node]
        vals = (list(watts) if isinstance(watts, (list, tuple))
                else [watts] * len(srcs))
        if len(vals) != len(srcs):
            raise ValueError(f"{node} has {len(srcs)} chips, got "
                             f"{len(vals)} powers")
        for src, w in zip(srcs, vals):
            src.set(float(w))

    # -- recording -----------------------------------------------------------

    @property
    def cursor(self) -> float:
        """Shared session clock (all node sessions advance in lock step)."""
        return next(iter(self.sessions.values())).cursor

    def sample(self, wall_s: float, tags=()) -> float:
        """Sample ``wall_s`` seconds on every node, flush each probe's
        window to its stream, and return the cluster energy of the window."""
        if self._closed:
            raise RuntimeError("ClusterRecorder is closed")
        total = 0.0
        for name, sess in self.sessions.items():
            streams = sess.sample_streams(wall_s, tags=tags)
            for blk in sess.drain():        # bound recorder memory
                total += blk.energy_j()
            if streams:
                for pid, block in streams.items():
                    self.writer.append(self._streams[name][pid], block)
        return total

    def close(self) -> str:
        if not self._closed:
            self.writer.meta["duration_s"] = self.cursor
            self._closed = True
            return self.writer.close()
        return self.writer.path

    def __enter__(self) -> "ClusterRecorder":
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# single-session export (live runs)


def record_session(session: MonitorSession, path, node: str = "node",
                   events: Optional[List] = None,
                   meta: Optional[Dict] = None) -> str:
    """Export a session's accumulated blocks to a single-stream trace.

    Each block becomes one chunk, so the session's window boundaries (one
    per ``sample()`` call) survive — ``replay_attribution`` re-drives an
    identical session window by window against the recorded power.
    ``events`` rows may be typed
    :class:`repro_torch.obs.TelemetryEvent`\\ s or legacy flat dicts; both
    serialize to the same meta schema.
    """
    rows = session.probe_rows()
    _, _, _, sps, volts = rows[0]
    m = {"kind": "session", "node": node, "grid_sps": session.grid_sps,
         "events": events_to_meta(events or [])}
    m.update(meta or {})
    with TraceWriter(path, meta=m) as w:
        sid = w.add_stream(f"{node}/probe0", node=node, sps=sps, volts=volts)
        for block in session.blocks():
            w.append(sid, block)
    return os.fspath(path)


def record_engine(tel, path, node: str = "serve-node",
                  meta: Optional[Dict] = None) -> str:
    """Export a serving engine's telemetry (``EngineTelemetry``): the
    session's sample windows plus the per-window event log (phase, wall
    time, token count, slot-tag -> request ids) that deterministic replay
    needs to reproduce the live per-request attribution."""
    return record_session(tel.session, path, node=node, events=tel.events,
                          meta=meta)
