"""Columnar sample streams (the telemetry hot path).

A :class:`SampleBlock` holds one probe stream's reports as numpy columns —
timestamps, watts, per-sample integration dt — plus a uint8 **GPIO bitmask**
per sample instead of per-object string tuples: bit ``i`` set means GPIO
line ``i`` was high when the report was taken, exactly what the main board's
PIC sees. Because a line can be recycled between tag names over a run
(``TagBus`` frees lines on lower), each block also carries the line->name
mapping per *segment* of samples sharing one tag-bus epoch, captured at read
time — so bit resolution is stable even as the live bus moves on.

Energy reductions (``energy_j``, ``energy_by_tag``, the per-request
``split_energy`` share computation) are vectorized numpy expressions over
these columns — ~10x+ over the legacy per-``Sample`` Python loops — and a
lazy :meth:`SampleBlock.samples` view recovers the legacy ``Sample`` objects
(string tag tuples included) for back-compat without paying for them unless
asked.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

from repro_torch.core.probe import AVG_N, REPORT_SPS, Sample


def _segment_epochs(epochs: np.ndarray) -> np.ndarray:
    """Offsets [k+1] of maximal runs of equal epoch values."""
    n = epochs.shape[0]
    if n == 0:
        return np.zeros(1, np.int64)
    cuts = np.flatnonzero(np.diff(epochs)) + 1
    return np.concatenate([[0], cuts, [n]]).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class SampleBlock:
    """One stream's reports in columnar form.

    ``seg_bounds``/``seg_maps`` partition the samples into runs sharing one
    GPIO line->name mapping: ``seg_maps[k]`` applies to samples
    ``seg_bounds[k]:seg_bounds[k+1]``.
    """

    t: np.ndarray               # [n] report timestamps (s)
    volts: np.ndarray           # [n]
    watts: np.ndarray           # [n]
    dt: np.ndarray              # [n] integration period per report (s)
    bits: np.ndarray            # [n] uint8 GPIO bitmask at report time
    seg_bounds: np.ndarray      # [k+1] int64 offsets
    seg_maps: Tuple[Mapping[int, str], ...]   # [k] line -> tag name
    n_avg: int = AVG_N

    @property
    def n(self) -> int:
        return int(self.t.shape[0])

    def __len__(self) -> int:
        return self.n

    @classmethod
    def empty(cls) -> "SampleBlock":
        z = np.zeros(0)
        return cls(t=z, volts=z, watts=z, dt=z,
                   bits=np.zeros(0, np.uint8),
                   seg_bounds=np.zeros(1, np.int64), seg_maps=())

    @classmethod
    def from_columns(cls, t: np.ndarray, watts: np.ndarray, *,
                     volts: float, dt: float, bits: np.ndarray,
                     epochs: np.ndarray,
                     epoch_maps) -> "SampleBlock":
        """Assemble a block from raw probe columns + tag-index lookups."""
        bounds = _segment_epochs(epochs)
        maps = tuple(dict(epoch_maps(int(epochs[s]))) if epochs.shape[0] else {}
                     for s in bounds[:-1])
        return cls(t=np.asarray(t, np.float64),
                   volts=np.full(t.shape, volts),
                   watts=np.asarray(watts, np.float64),
                   dt=np.full(t.shape, dt),
                   bits=np.asarray(bits, np.uint8),
                   seg_bounds=bounds, seg_maps=maps)

    @classmethod
    def concat(cls, blocks: Sequence["SampleBlock"]) -> "SampleBlock":
        blocks = [b for b in blocks if b.n]
        if not blocks:
            return cls.empty()
        if len(blocks) == 1:
            return blocks[0]
        bounds, off, maps = [np.zeros(1, np.int64)], 0, []
        for b in blocks:
            bounds.append(b.seg_bounds[1:] + off)
            maps.extend(b.seg_maps)
            off += b.n
        return cls(
            t=np.concatenate([b.t for b in blocks]),
            volts=np.concatenate([b.volts for b in blocks]),
            watts=np.concatenate([b.watts for b in blocks]),
            dt=np.concatenate([b.dt for b in blocks]),
            bits=np.concatenate([b.bits for b in blocks]),
            seg_bounds=np.concatenate(bounds), seg_maps=tuple(maps))

    # -- vectorized reductions ----------------------------------------------

    @property
    def amps(self) -> np.ndarray:
        return np.divide(self.watts, self.volts,
                         out=np.zeros_like(self.watts),
                         where=self.volts != 0)

    def energy_j(self) -> float:
        """Integral of averaged power over each report's actual period."""
        return float(self.watts @ self.dt)

    def duration_s(self) -> float:
        return float(self.dt.sum())

    def avg_power_w(self) -> float:
        d = self.duration_s()
        return self.energy_j() / d if d > 0 else 0.0

    def tag_mask(self, name: str) -> np.ndarray:
        """Boolean [n]: samples taken while tag ``name`` was high."""
        out = np.zeros(self.n, bool)
        for k, m in enumerate(self.seg_maps):
            for idx, nm in m.items():
                if nm == name:
                    s, e = self.seg_bounds[k], self.seg_bounds[k + 1]
                    out[s:e] = (self.bits[s:e] >> idx) & 1
        return out

    def tag_names(self) -> Tuple[str, ...]:
        names = {nm for m in self.seg_maps for nm in m.values()}
        return tuple(sorted(names))

    def energy_by_tag(self) -> Dict[str, float]:
        """Per-tag energy: vectorized counterpart of the legacy
        ``MainBoard.energy_by_tag`` per-object loop."""
        e = self.watts * self.dt
        out: Dict[str, float] = {}
        for k, m in enumerate(self.seg_maps):
            if not m:
                continue
            s, end = self.seg_bounds[k], self.seg_bounds[k + 1]
            seg_bits, seg_e = self.bits[s:end], e[s:end]
            for idx, name in m.items():
                sel = (seg_bits >> idx) & 1
                if sel.any():
                    out[name] = out.get(name, 0.0) + float(seg_e @ sel)
        return out

    def split_energy(self, group_sizes: Mapping[str, int]) -> Dict[str, float]:
        """Equal-share attribution: each sample's energy splits evenly among
        all members of all listed tag groups active at that sample; returns
        each *tag's* aggregate share (divide by the group size for the
        per-member share). Matches the legacy per-sample loop exactly.
        """
        if not self.n or not group_sizes:
            return {}
        e = self.watts * self.dt
        sel = {name: self.tag_mask(name) for name in group_sizes}
        sharers = np.zeros(self.n, np.float64)
        for name, mask in sel.items():
            sharers += group_sizes[name] * mask
        safe = np.maximum(sharers, 1.0)
        return {name: float((e * mask * (group_sizes[name] / safe)).sum())
                for name, mask in sel.items()}

    # -- legacy view ---------------------------------------------------------

    def samples(self) -> "SampleView":
        """Lazy ``Sample``-object view (legacy string-tuple tags)."""
        return SampleView(self)


class SampleView(Sequence):
    """Lazy back-compat view of a :class:`SampleBlock` as ``Sample`` objects
    with resolved string tag tuples; materializes one object per access."""

    def __init__(self, block: SampleBlock):
        self._b = block

    def __len__(self) -> int:
        return self._b.n

    def _resolve_tags(self, i: int) -> Tuple[str, ...]:
        b = self._b
        k = int(np.searchsorted(b.seg_bounds, i, side="right")) - 1
        m = b.seg_maps[k] if 0 <= k < len(b.seg_maps) else {}
        bits = int(b.bits[i])
        return tuple(sorted(m[idx] for idx in m if bits & (1 << idx)))

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        b = self._b
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        volts = float(b.volts[i])
        watts = float(b.watts[i])
        return Sample(t=float(b.t[i]), volts=volts,
                      amps=round(watts / volts, 6) if volts else 0.0,
                      watts=watts, n_avg=b.n_avg,
                      tags=self._resolve_tags(i), dt=float(b.dt[i]))


def read_board_blocks(board, duration: float) -> Dict[int, SampleBlock]:
    """Columnar read of every probe on a :class:`MainBoard`: advances the
    board clock by ``duration`` and returns per-probe ``SampleBlock``s with
    GPIO bitmasks resolved through the tag bus's compiled interval index
    (one vectorized lookup per stream, not one replay per sample)."""
    t0 = board.now
    idx = board.tags.index()
    out: Dict[int, SampleBlock] = {}
    for pid, _, probe, sps in board.probes():
        t, watts = probe.read_block(t0, duration, sps=sps)
        bits, epochs = idx.states_at(t)
        out[pid] = SampleBlock.from_columns(
            t, watts, volts=probe.cfg.volts_nominal,
            dt=1.0 / sps if sps else 1.0 / REPORT_SPS,
            bits=bits, epochs=epochs, epoch_maps=idx.map_at)
    board.advance(duration)
    return out
