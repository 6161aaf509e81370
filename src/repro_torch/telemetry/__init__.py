"""Unified telemetry API for the paper's energy-monitoring platform.

Everything outside this package consumes the measurement pipeline (INA228
probes -> PIC18 main board -> 8-line GPIO tag bus, paper Sec. 4) through
:class:`MonitorSession`:

- :mod:`~repro_torch.telemetry.source` — what the probes measure (``ModelSource``
  for roofline/DVFS traces, ``MutableSource`` for host-updated power,
  ``TraceSource`` for recorded arrays);
- :mod:`~repro_torch.telemetry.session` — ``MonitorSession`` facade: region
  tagging, grid-aligned sampling windows, typed ``EnergyReport``;
- :mod:`~repro_torch.telemetry.samples` — columnar ``SampleBlock`` streams
  (numpy columns + per-sample GPIO bitmask) with vectorized energy
  reductions and a lazy legacy ``Sample`` view.
"""
from repro_torch.core.probe import (AVG_N, MILLIWATT, RAW_SPS, REPORT_SPS,
                              ProbeConfig, read_vectorized)
from repro_torch.telemetry.samples import SampleBlock, SampleView, read_board_blocks
from repro_torch.telemetry.session import EnergyReport, MonitorSession, Window
from repro_torch.telemetry.source import (ModelSource, MutableSource, PowerSource,
                                    TraceExhausted, TraceSource, constant)

__all__ = [
    "MonitorSession", "Window", "EnergyReport",
    "SampleBlock", "SampleView", "read_board_blocks",
    "PowerSource", "ModelSource", "MutableSource", "TraceSource",
    "TraceExhausted", "constant",
    # platform constants / probe config re-exported for consumers
    "ProbeConfig", "read_vectorized",
    "AVG_N", "MILLIWATT", "RAW_SPS", "REPORT_SPS",
]
