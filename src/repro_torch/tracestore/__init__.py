"""Trace store: durable, replayable power recordings (``.dkt`` files).

The telemetry platform (``repro_torch.telemetry``) measures at 1000 SPS
with milliwatt resolution, but a measurement that dies with the process is a
demo, not an instrument. This package persists ``SampleBlock`` streams
bit-exactly and replays them deterministically:

- :mod:`~repro_torch.tracestore.format` — the chunked, versioned ``.dkt``
  binary layout (columnar payloads, interned tag table, indexed footer);
- :mod:`~repro_torch.tracestore.io` — ``TraceWriter`` / mmap-backed
  ``TraceReader`` with O(log chunks) time seeks;
- :mod:`~repro_torch.tracestore.recorder` — ``ClusterRecorder`` (one session
  per topology node, one probe per chip, shared clock) and
  ``record_session``/``record_engine`` for live-run export;
- :mod:`~repro_torch.tracestore.replay` — deterministic replay: bit-exact
  session reconstruction (``replay_attribution``), admission-policy
  regression (``replay_policy`` -> ``ReplayReport``), and recorded-power
  cluster scheduling (``replay_cluster``).
"""
from repro_torch.tracestore.format import (ChunkInfo, TraceFormatError,
                                           VERSION)
from repro_torch.tracestore.io import TraceReader, TraceWriter, slice_block
from repro_torch.tracestore.recorder import (ClusterRecorder, record_engine,
                                             record_session)
from repro_torch.tracestore.replay import (ClusterJobResult, EnergyTimeline,
                                           PolicyResult, ReplayReport,
                                           ReplayRequest, node_power_fn,
                                           rebuild_sources, replay,
                                           replay_attribution,
                                           replay_cluster, replay_policy,
                                           replay_session)

__all__ = [
    "VERSION", "ChunkInfo", "TraceFormatError",
    "TraceReader", "TraceWriter", "slice_block",
    "ClusterRecorder", "record_session", "record_engine",
    "ReplayRequest", "PolicyResult", "ClusterJobResult", "ReplayReport",
    "EnergyTimeline",
    "rebuild_sources", "node_power_fn", "replay", "replay_attribution",
    "replay_cluster", "replay_policy", "replay_session",
]
