"""``MonitorSession`` — the single host-side energy-monitoring API.

The facade over the paper's measurement platform (probe -> main board ->
GPIO tag bus, Sec. 4): a session owns one board, attaches one probe per
:mod:`power source <repro_torch.telemetry.source>`, keeps the board clock on the
global report grid, and accumulates columnar
:class:`~repro_torch.telemetry.samples.SampleBlock` streams.

    src = MutableSource(idle_w)
    session = MonitorSession(src, node="train-node")
    with session.region("train_step"):          # GPIO region tagging
        ...run the step...
        src.set(measured_w)
        session.sample(wall_s)                  # 1000 SPS columnar read
    report = session.report(tokens=n)           # EnergyReport: J, J/token,
                                                # per-tag J, avg W, samples

Sampling windows are aligned to the 1-kHz report grid: a sub-millisecond
step carries its fractional sample into the next window instead of silently
dropping energy, so the residual against wall time is bounded by one sample
period at all times. ``session.window()`` scopes a report to one call
(replacing the old engines' hand-rolled cursor arithmetic).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Union

from repro_torch.core.mainboard import MainBoard
from repro_torch.core.probe import Probe, ProbeConfig, REPORT_SPS
from repro_torch.telemetry.samples import SampleBlock, read_board_blocks
from repro_torch.telemetry.source import PowerSource


@dataclasses.dataclass(frozen=True)
class EnergyReport:
    """Typed summary of a monitored interval.

    ``counters`` carries session-level event counts (``session.count``) —
    e.g. the serving engines' per-step jit compile counts — so compile
    activity rides the same report the energy numbers do."""

    energy_j: float
    by_tag: Dict[str, float]
    avg_power_w: float
    n_samples: int
    duration_s: float
    j_per_token: Optional[float] = None
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)

    def __str__(self) -> str:
        tags = {k: round(v, 3) for k, v in sorted(self.by_tag.items())}
        jt = (f" {self.j_per_token:.4f} J/token"
              if self.j_per_token is not None else "")
        cnt = (f" counters={dict(sorted(self.counters.items()))}"
               if self.counters else "")
        return (f"{self.energy_j:.3f} J over {self.duration_s:.3f} s "
                f"({self.avg_power_w:.1f} W avg, {self.n_samples} samples)"
                f"{jt} by_tag={tags}{cnt}")


class Window:
    """A contiguous span of a session's sample stream (one engine call,
    one benchmark iteration, ...). Obtained from ``session.window()``."""

    def __init__(self, session: "MonitorSession"):
        self._session = session
        self._start = session._abs_len          # absolute block index
        self._t0 = session.cursor
        self._end: Optional[int] = None
        self._t1: Optional[float] = None

    def close(self):
        if self._end is None:
            self._end = self._session._abs_len
            self._t1 = self._session.cursor

    def blocks(self) -> List[SampleBlock]:
        end = self._end if self._end is not None else self._session._abs_len
        lo = self._start - self._session._n_dropped
        if lo < 0:
            raise RuntimeError(
                "window blocks were drained/reset out of the session; "
                "close windows before drain() or report from the drained "
                "blocks directly")
        return self._session._blocks[lo:end - self._session._n_dropped]

    def report(self, tokens: Optional[int] = None) -> EnergyReport:
        t1 = self._t1 if self._t1 is not None else self._session.cursor
        return self._session._report_over(self.blocks(), t1 - self._t0, tokens)


class MonitorSession:
    """One node's monitoring session: board + probes + tag bus + streams."""

    def __init__(self, source: Union[PowerSource, Sequence[PowerSource]],
                 node: str = "node", clock_t0: float = 0.0,
                 probe_cfg: Optional[ProbeConfig] = None,
                 grid_sps: float = REPORT_SPS,
                 oversubscribe: bool = False):
        sources = (list(source) if isinstance(source, (list, tuple))
                   else [source])
        if not sources:
            raise ValueError("MonitorSession needs at least one power source")
        self.sources = sources
        self.source = sources[0]
        self._board = MainBoard(node, clock_t0)
        base = probe_cfg or ProbeConfig()
        for i, src in enumerate(sources):
            self._board.attach(Probe(src, dataclasses.replace(
                base, probe_id=base.probe_id + i)),
                oversubscribe=oversubscribe)
        self._grid = float(grid_sps)
        self._cursor = float(clock_t0)
        self._origin = float(clock_t0)
        self._blocks: List[SampleBlock] = []
        self._n_dropped = 0          # blocks removed by drain()/reset()
        self._total_j = 0.0
        self._counters: Dict[str, float] = {}

    # -- clock / board -------------------------------------------------------

    @property
    def cursor(self) -> float:
        """Wall-time position of the session (sampling resumes here)."""
        return self._cursor

    @property
    def grid_sps(self) -> float:
        """The report grid sampling windows are aligned to."""
        return self._grid

    @property
    def board(self) -> MainBoard:
        """The underlying main board (tests / advanced wiring only)."""
        return self._board

    @property
    def tags(self):
        return self._board.tags

    # -- tagging -------------------------------------------------------------

    def region(self, name: str):
        """``with session.region("prefill"): ...`` — GPIO region tagging."""
        return self._board.tags.tag(name)

    # -- counters ------------------------------------------------------------

    def count(self, name: str, n: float = 1):
        """Bump a session-level event counter (jit compiles, cache misses,
        sheds, ...). Counters land on :class:`EnergyReport` so activity that
        burns watts without moving tokens — XLA compilation above all — is
        visible next to the energy it cost, and cleared by :meth:`reset`."""
        self._counters[name] = self._counters.get(name, 0) + n

    @property
    def counters(self) -> Dict[str, float]:
        return dict(self._counters)

    # -- sampling ------------------------------------------------------------

    def sample(self, wall_s: float, tags: Iterable[str] = ()) -> SampleBlock:
        """Sample ``wall_s`` seconds of source power through the board.

        The read is kept on the global report grid: the window's sample
        count is ``round(end*sps) - round(start*sps)``, so fractional
        periods roll into the next window (residual <= one sample period).
        Extra ``tags`` are raised for just this window; longer-lived regions
        use :meth:`region`. Returns the window's (possibly empty) block,
        concatenated over probes."""
        streams = self.sample_streams(wall_s, tags)
        return self._blocks[-1] if streams is not None else SampleBlock.empty()

    def sample_streams(self, wall_s: float,
                       tags: Iterable[str] = ()) -> Optional[Dict[int, SampleBlock]]:
        """Like :meth:`sample` but also returns the window's per-probe
        blocks keyed by probe id (the export hook recorders persist streams
        through — one ``.dkt`` stream per probe). The concatenated window
        still lands on the session's block list, so reports are unchanged.
        Returns None for a non-positive window."""
        if wall_s <= 0:
            return None
        end = self._cursor + wall_s
        read_s = (round(end * self._grid)
                  - round(self._cursor * self._grid)) / self._grid
        tags = list(tags)
        for tg in tags:
            self._board.tags.raise_(tg)
        try:
            streams = (read_board_blocks(self._board, read_s)
                       if read_s > 0 else {})
        finally:
            for tg in reversed(tags):
                self._board.tags.lower(tg)
        self._board.advance(wall_s - read_s)   # keep board clock on wall time
        self._cursor = end
        block = SampleBlock.concat(list(streams.values()))
        self._blocks.append(block)
        self._total_j += block.energy_j()
        return streams

    # -- windows / reports ---------------------------------------------------

    @contextlib.contextmanager
    def window(self):
        """Scope a report to the samples taken inside the ``with`` block."""
        w = Window(self)
        try:
            yield w
        finally:
            w.close()

    def blocks(self) -> List[SampleBlock]:
        return list(self._blocks)

    @property
    def n_windows(self) -> int:
        """Sample windows currently held (index space of the next window —
        the engines stamp this onto their telemetry events *before*
        sampling, so event ``k`` always describes block ``k``)."""
        return len(self._blocks)

    def block(self) -> SampleBlock:
        """All samples so far as one block."""
        return SampleBlock.concat(self._blocks)

    @property
    def _abs_len(self) -> int:
        """Blocks sampled over the session lifetime (drained or not);
        windows anchor on this so a drain can't silently shift them."""
        return self._n_dropped + len(self._blocks)

    def drain(self) -> List[SampleBlock]:
        """Pop the accumulated blocks (recorder flush hook): returns every
        block sampled since the last drain and clears the in-memory list so
        long recordings don't grow without bound. The clock cursor and the
        O(1) :meth:`energy_j` running total keep going; :meth:`report`
        afterwards only covers still-undrained blocks, and a ``Window``
        opened before the drain raises rather than reporting wrong energy."""
        out, self._blocks = self._blocks, []
        self._n_dropped += len(out)
        return out

    def probe_rows(self) -> List[tuple]:
        """(probe_id, bus, power_source, effective_sps, volts_nominal) per
        probe, in the board's stream order — the key recorders use to tie
        per-probe sample streams back to their power sources."""
        return [(pid, bus, probe.power_fn, sps, probe.cfg.volts_nominal)
                for pid, bus, probe, sps in self._board.probes()]

    def _report_over(self, blocks: List[SampleBlock], duration_s: float,
                     tokens: Optional[int] = None) -> EnergyReport:
        total, n = 0.0, 0
        by_tag: Dict[str, float] = {}
        for b in blocks:
            total += b.energy_j()
            n += b.n
            for k, v in b.energy_by_tag().items():
                by_tag[k] = by_tag.get(k, 0.0) + v
        return EnergyReport(
            energy_j=total, by_tag=by_tag,
            avg_power_w=total / duration_s if duration_s > 0 else 0.0,
            n_samples=n, duration_s=duration_s,
            j_per_token=(total / max(tokens, 1)
                         if tokens is not None else None))

    def energy_j(self) -> float:
        """Running session energy total (O(1); maintained as windows are
        sampled — per-step logging should use this, not ``report()``,
        which re-reduces per-tag energy over every block)."""
        return self._total_j

    def report(self, tokens: Optional[int] = None) -> EnergyReport:
        """Session-lifetime energy report (since construction or the last
        :meth:`reset`)."""
        rep = self._report_over(self._blocks, self._cursor - self._origin,
                                tokens)
        if self._counters:
            rep = dataclasses.replace(rep, counters=dict(self._counters))
        return rep

    def reset(self):
        """Drop accumulated samples and counters (benchmark warmup); the
        board clock and tag bus keep running."""
        self._n_dropped += len(self._blocks)
        self._blocks = []
        self._origin = self._cursor
        self._total_j = 0.0
        self._counters = {}
