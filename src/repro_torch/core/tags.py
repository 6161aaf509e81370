"""GPIO region tagging (paper Sec. 4.1/4.3).

The main board has eight GPIO inputs driven by the measured node, so running
code can tag samples with the active code segment ("measure the consumption
of a specific function"). We reproduce the exact constraint: at most 8
concurrent binary channels; a tag is a named channel raised/lowered around a
code region, and samples record the set of channels high at sample time.

A GPIO line is only occupied while its tag is high: lowering a tag releases
the line for reuse, so any number of *distinct* tag names may be used over a
run as long as no more than 8 are ever high at once (the hardware limit).

Lookups go through an incrementally compiled interval index (``TagIndex``):
each event appends one epoch (a snapshot of the 8-line state plus the
line->name map), and ``active_at`` is a binary search into the epoch
timeline instead of an O(events) replay of the whole log — the columnar
sampling path queries whole timestamp arrays against it at once.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

N_GPIO = 8


class TagIndex:
    """Immutable epoch timeline snapshot of a :class:`TagBus` event log.

    Epoch ``k`` covers ``(times[k], times[k+1]]``: ``states[k]`` is the
    8-line bitmask after event ``k`` was applied and ``maps[k]`` the
    ``line -> name`` mapping in force. Times at an event boundary resolve to
    the *later* epoch (an event at exactly ``t`` is applied at ``t``),
    matching the original replay semantics.
    """

    def __init__(self, times: np.ndarray, states: np.ndarray,
                 maps: List[Mapping[int, str]], n: int):
        # zero-copy views of the bus's append-only buffers: entries below
        # ``n`` never mutate, so the snapshot stays consistent even as the
        # bus keeps logging (a buffer regrow leaves old views intact)
        self._times = times[:n]
        self._states = states[:n]
        self._maps = maps                       # shared, append-only list
        self._n = n                             # snapshot length

    def __len__(self) -> int:
        return self._n

    def epoch_at(self, t: float) -> int:
        """Index of the epoch covering time ``t`` (-1 before any event)."""
        return int(np.searchsorted(self._times, t, side="right")) - 1

    def epochs_at(self, t: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`epoch_at` for a sorted-or-not time array."""
        return np.searchsorted(self._times, t, side="right").astype(np.int64) - 1

    def states_at(self, t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(uint8 bitmask per time, epoch per time) for an array of times."""
        epochs = self.epochs_at(t)
        if not self._n:
            return np.zeros(epochs.shape, np.uint8), epochs
        bits = np.where(epochs >= 0, self._states[np.clip(epochs, 0, None)],
                        np.uint8(0)).astype(np.uint8)
        return bits, epochs

    def map_at(self, epoch: int) -> Mapping[int, str]:
        """line -> name mapping in force during ``epoch`` ({} before t0)."""
        if epoch < 0 or epoch >= self._n:
            return {}
        return self._maps[epoch]

    def active_at(self, t: float) -> Tuple[str, ...]:
        k = self.epoch_at(t)
        if k < 0:
            return ()
        state, m = self._states[k], self._maps[k]
        return tuple(sorted(m[i] for i in m if state & (1 << i)))


class TagBus:
    """The 8-channel GPIO bus between the node and its main board."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._channels: Dict[str, int] = {}     # name -> gpio index (while high)
        self._high: Dict[int, str] = {}         # gpio index -> name
        self._events: List[Tuple[float, int, str, bool]] = []
        # incrementally compiled epoch timeline (one entry per event):
        # growable numpy buffers (capacity-doubled) so TagIndex snapshots
        # are zero-copy views and compilation is amortized O(1) per event
        self._idx_times = np.zeros(16, np.float64)
        self._idx_states = np.zeros(16, np.uint8)
        self._idx_maps: List[Mapping[int, str]] = []
        self._idx_high: Dict[int, str] = {}     # replay cursor state
        self._compiled_upto = 0
        self._index_cache: Optional[TagIndex] = None

    def _alloc(self, name: str) -> int:
        if name in self._channels:
            return self._channels[name]
        if len(self._channels) >= N_GPIO:
            raise RuntimeError(
                f"all {N_GPIO} GPIO tag channels in use (paper HW limit)")
        idx = next(i for i in range(N_GPIO)
                   if i not in self._channels.values())
        self._channels[name] = idx
        return idx

    def raise_(self, name: str):
        with self._lock:
            idx = self._alloc(name)
            self._high[idx] = name
            self._events.append((self._clock(), idx, name, True))
            self._index_cache = None

    def lower(self, name: str):
        with self._lock:
            idx = self._channels.get(name)
            if idx is not None and idx in self._high:
                del self._high[idx]
                # release the GPIO line: only concurrent tags occupy channels
                del self._channels[name]
                self._events.append((self._clock(), idx, name, False))
                self._index_cache = None

    # -- compiled interval index --------------------------------------------

    def _compile_locked(self):
        """Extend the epoch timeline with any events logged since the last
        compile (amortized O(1) per event; no full-log replay)."""
        need = len(self._events)
        if need > self._idx_times.shape[0]:
            cap = max(2 * self._idx_times.shape[0], need)
            self._idx_times = np.concatenate(
                [self._idx_times, np.zeros(cap - self._idx_times.shape[0])])
            self._idx_states = np.concatenate(
                [self._idx_states,
                 np.zeros(cap - self._idx_states.shape[0], np.uint8)])
        for k in range(self._compiled_upto, need):
            et, idx, name, up = self._events[k]
            if up:
                self._idx_high[idx] = name
            else:
                self._idx_high.pop(idx, None)
            state = 0
            for i in self._idx_high:
                state |= 1 << i
            self._idx_times[k] = et
            self._idx_states[k] = state
            self._idx_maps.append(dict(self._idx_high))
        self._compiled_upto = need

    def index(self) -> TagIndex:
        """Compiled epoch timeline for interval/bitmask lookups (cached
        until the next raise/lower)."""
        with self._lock:
            if self._index_cache is None:
                self._compile_locked()
                self._index_cache = TagIndex(self._idx_times, self._idx_states,
                                             self._idx_maps,
                                             n=len(self._idx_maps))
            return self._index_cache

    def active_at(self, t: float) -> Tuple[str, ...]:
        """Tags high at time t (binary search into the epoch timeline)."""
        return self.index().active_at(t)

    def active_now(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._high.values()))

    @contextlib.contextmanager
    def tag(self, name: str):
        """``with bus.tag("fwd"): ...`` — energy attribution for a region."""
        self.raise_(name)
        try:
            yield
        finally:
            self.lower(name)

    def intervals(self, name: str) -> List[Tuple[float, Optional[float]]]:
        """(start, end) intervals for a tag; end=None if still high."""
        out: List[Tuple[float, Optional[float]]] = []
        start = None
        with self._lock:
            events = list(self._events)
        for et, _, n, up in events:
            if n != name:
                continue
            if up and start is None:
                start = et
            elif not up and start is not None:
                out.append((start, et))
                start = None
        if start is not None:
            out.append((start, None))
        return out
