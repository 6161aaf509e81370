"""Typed telemetry event schema.

One event per engine sampling window: the record the replay harness
(``tracestore.replay.replay_attribution``) re-drives against recorded
power, and the record the timeline exporter (``obs.export``) merges with
span streams. Before this schema the engines logged raw dicts and every
consumer re-invented the key names; now ``EngineTelemetry``, the trace
store, and the exporter share one format.

``window`` is the event's index into the session's sample-block list: the
k-th event describes the k-th ``MonitorSession`` window, which is also the
k-th recorded chunk of a ``.dkt`` stream exported by ``record_engine`` —
the invariant that lets spans reference windows by index and lets a
recorded trace replay into the same timeline as the live run.

Serialized form is a flat JSON dict (``as_dict``) identical to the legacy
ad-hoc event log, so traces recorded before the schema existed load
unchanged (``from_dict`` treats unknown keys as ``extra``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Mapping, Optional, Tuple

_KNOWN = ("phase", "wall_s", "n_tokens", "groups", "window", "t0")


@dataclasses.dataclass(frozen=True)
class TelemetryEvent:
    """One sampling window of an engine run.

    ``groups`` maps each GPIO slot tag raised for the window to the request
    ids sharing it (the tag-bus attribution input). ``extra`` carries
    optional per-window annotations (e.g. ``cached_tokens`` on a
    prefix-cache hit) that ride into the trace meta and the span timeline.
    """

    phase: str                                # "prefill" | "decode" | ...
    wall_s: float
    n_tokens: int                             # computed tokens this window
    groups: Mapping[str, Tuple[int, ...]]     # slot tag -> request ids
    window: int = -1                          # session sample-block index
    t0: float = 0.0                           # session cursor at window start
    extra: Mapping[str, object] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict:
        """Flat JSON-serializable form (legacy-log compatible)."""
        out: Dict = {"phase": self.phase, "wall_s": self.wall_s,
                     "n_tokens": self.n_tokens,
                     "groups": {tg: list(ids)
                                for tg, ids in self.groups.items()},
                     "window": self.window, "t0": self.t0}
        out.update(self.extra)
        return out

    @classmethod
    def from_dict(cls, d: Mapping) -> "TelemetryEvent":
        """Parse an event dict — new flat form or a pre-schema legacy log
        entry (no ``window``/``t0``; any other keys become ``extra``)."""
        extra = {k: v for k, v in d.items() if k not in _KNOWN}
        return cls(phase=d["phase"], wall_s=float(d["wall_s"]),
                   n_tokens=int(d.get("n_tokens", 0)),
                   groups={tg: tuple(ids)
                           for tg, ids in d.get("groups", {}).items()},
                   window=int(d.get("window", -1)),
                   t0=float(d.get("t0", 0.0)), extra=extra)

    # -- mapping-style access (legacy consumers indexed raw dicts) -----------

    def __getitem__(self, key: str):
        d = self.as_dict()
        return d[key]

    def get(self, key: str, default=None):
        return self.as_dict().get(key, default)

    def __contains__(self, key: str) -> bool:
        return key in self.as_dict()

    def keys(self) -> Iterator[str]:
        return iter(self.as_dict())


def coerce_event(e) -> TelemetryEvent:
    """Accept either a :class:`TelemetryEvent` or a raw event dict."""
    return e if isinstance(e, TelemetryEvent) else TelemetryEvent.from_dict(e)


def events_to_meta(events) -> list:
    """Serialize an event log for a trace file's JSON meta footer."""
    return [coerce_event(e).as_dict() for e in (events or [])]


def events_from_meta(rows) -> list:
    """Parse a trace meta event log back into typed events."""
    return [coerce_event(r) for r in (rows or [])]


def window_of(e) -> Optional[int]:
    """Window index of an event, None when the event predates the schema."""
    w = coerce_event(e).window
    return w if w >= 0 else None
