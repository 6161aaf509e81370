"""Chrome-trace-event / Perfetto timeline export with energy attribution.

Turns a :class:`~repro_torch.obs.spans.Tracer`'s span stream into the JSON
object format Perfetto (ui.perfetto.dev) and ``chrome://tracing`` load
directly: one ``X`` (complete) event per span, one timeline row per track
("engine" plus one ``req<N>`` row per request), and a ``board_power_w``
counter series derived from the ``MonitorSession`` energy windows.

Energy attribution is the point: a span whose ``window`` (or ``windows``)
attribute references session sample-window indices gets those windows'
joules as ``args.energy_j``. The engines reference every window from
exactly one step span, so the per-span joules **partition** the session
total — ``sum(span energy) == EnergyReport.energy_j`` exactly, the tested
acceptance bar — and Perfetto shows where every joule of a run went.

A recorded ``.dkt`` trace replays into the same timeline:
:func:`timeline_from_trace` rebuilds phase spans from the typed event log
(one event per recorded chunk, ``obs.events``) with energies read from the
recorded sample blocks, so live export and offline replay produce the same
document shape.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.events import coerce_event
from repro_torch.obs.spans import SpanRecord, Tracer

__all__ = ["chrome_trace", "write_chrome_trace", "validate_chrome_trace",
           "parse_chrome_trace", "timeline_from_trace", "session_energies"]

_US = 1e6                    # trace-event timestamps are microseconds
PID = 1                      # one process per document


def session_energies(session) -> Tuple[List[float], List[float]]:
    """(energy_j, duration_s) per sample window of a ``MonitorSession``
    (index-aligned with the engine's typed event log)."""
    blocks = session.blocks()
    return ([b.energy_j() for b in blocks], [b.duration_s() for b in blocks])


def _span_windows(rec: SpanRecord) -> List[int]:
    w = rec.attrs.get("window")
    ws = rec.attrs.get("windows")
    out = []
    if w is not None and int(w) >= 0:
        out.append(int(w))
    if ws:
        out.extend(int(i) for i in ws)
    return out


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


def chrome_trace(spans: Sequence[SpanRecord],
                 window_energies: Optional[Sequence[float]] = None,
                 window_walls: Optional[Sequence[float]] = None,
                 meta: Optional[Dict] = None,
                 n_dropped: int = 0) -> Dict:
    """Build the trace-event JSON document (pure function of its inputs).

    ``window_energies[i]`` is the joules of session sample window ``i``;
    spans referencing windows get the summed joules as ``args.energy_j``.
    A window referenced by more than one span raises — double-attributed
    joules would silently break the sum-to-total invariant.
    """
    energies = list(window_energies or [])
    walls = list(window_walls or [])
    events: List[Dict] = [{
        "name": "process_name", "ph": "M", "pid": PID, "tid": 0,
        "args": {"name": (meta or {}).get("process", "dalek")}}]

    tracks = []
    for r in spans:
        if r.track not in tracks:
            tracks.append(r.track)
    if "engine" in tracks:                      # engine row always on top
        tracks.remove("engine")
        tracks.insert(0, "engine")
    tids = {tr: i for i, tr in enumerate(tracks)}
    for tr, tid in tids.items():
        events.append({"name": "thread_name", "ph": "M", "pid": PID,
                       "tid": tid, "args": {"name": tr}})

    claimed: Dict[int, int] = {}                # window -> span_id
    attributed = 0.0
    for r in sorted(spans, key=lambda r: (r.t0, r.span_id)):
        args = {"span_id": r.span_id, "parent_id": r.parent_id}
        args.update({k: _jsonable(v) for k, v in r.attrs.items()})
        wins = _span_windows(r)
        e_j = 0.0
        for w in wins:
            if w in claimed:
                raise ValueError(
                    f"window {w} referenced by spans {claimed[w]} and "
                    f"{r.span_id}: joules would be attributed twice")
            claimed[w] = r.span_id
            if w < len(energies):
                e_j += energies[w]
        if wins:
            args["energy_j"] = e_j
            attributed += e_j
        base = {"name": r.name, "cat": r.track, "pid": PID,
                "tid": tids[r.track], "ts": r.t0 * _US, "args": args}
        if r.t1 > r.t0:
            events.append({**base, "ph": "X",
                           "dur": (r.t1 - r.t0) * _US})
        else:
            events.append({**base, "ph": "i", "s": "t"})
        # power counter series: one point per referenced window, at the
        # span's start, so the Perfetto counter row tracks the span rows
        for w in wins:
            if w < len(energies):
                wall = (walls[w] if w < len(walls) and walls[w] > 0
                        else max(r.t1 - r.t0, 1e-9))
                events.append({
                    "name": "board_power_w", "ph": "C", "pid": PID,
                    "tid": tids[r.track], "ts": r.t0 * _US,
                    "args": {"W": energies[w] / wall}})

    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "energy_total_j": float(sum(energies)),
            "attributed_j": float(attributed),
            "n_windows": len(energies),
            "n_spans": len(spans),
            "dropped_spans": int(n_dropped),
            **{k: _jsonable(v) for k, v in (meta or {}).items()},
        },
    }
    validate_chrome_trace(doc)
    return doc


def write_chrome_trace(path, tracer_or_spans, session=None,
                       window_energies: Optional[Sequence[float]] = None,
                       window_walls: Optional[Sequence[float]] = None,
                       meta: Optional[Dict] = None) -> str:
    """Validate and write a timeline JSON. Pass the live ``session`` (its
    sample windows supply the energies) or explicit per-window joules."""
    if isinstance(tracer_or_spans, Tracer):
        spans = tracer_or_spans.spans()
        n_dropped = tracer_or_spans.n_dropped
    else:
        spans, n_dropped = list(tracer_or_spans), 0
    if session is not None:
        if window_energies is not None:
            raise ValueError("pass session or window_energies, not both")
        window_energies, window_walls = session_energies(session)
    doc = chrome_trace(spans, window_energies, window_walls, meta=meta,
                       n_dropped=n_dropped)
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, separators=(",", ":"))
    return str(path)


# ---------------------------------------------------------------------------
# validation + parse-back


_PH_KNOWN = {"X", "B", "E", "i", "C", "M"}


def validate_chrome_trace(doc) -> None:
    """Schema check (raises ``ValueError``): the subset of the trace-event
    format the exporter emits, strict enough that Perfetto will load any
    document that passes."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a trace document: missing traceEvents")
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("traceEvents must be a list")
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            raise ValueError(f"traceEvents[{i}] is not an object")
        for k in ("name", "ph", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"traceEvents[{i}] missing {k!r}")
        ph = ev["ph"]
        if ph not in _PH_KNOWN:
            raise ValueError(f"traceEvents[{i}]: unknown phase {ph!r}")
        if ph in ("X", "i", "C", "B", "E") and "ts" not in ev:
            raise ValueError(f"traceEvents[{i}]: {ph} event missing ts")
        if ph == "X":
            if "dur" not in ev or float(ev["dur"]) < 0:
                raise ValueError(
                    f"traceEvents[{i}]: X event needs non-negative dur")
        if ph == "C" and "args" not in ev:
            raise ValueError(f"traceEvents[{i}]: counter missing args")
    od = doc.get("otherData", {})
    for k in ("energy_total_j", "attributed_j"):
        if k in od and not isinstance(od[k], (int, float)):
            raise ValueError(f"otherData.{k} must be numeric")


def parse_chrome_trace(doc_or_path) -> Tuple[List[SpanRecord], Dict]:
    """Parse a written timeline back into span records + a summary.

    Round-trip contract (tested): span ids, parentage, tracks, times
    (to trace-event microsecond resolution), attributes, and per-span
    ``energy_j`` all survive; ``summary['attributed_j']`` equals the sum
    of the parsed per-span energies.
    """
    if isinstance(doc_or_path, (str, bytes)) or hasattr(doc_or_path,
                                                        "__fspath__"):
        with open(doc_or_path) as f:
            doc = json.load(f)
    else:
        doc = doc_or_path
    validate_chrome_trace(doc)
    tracks: Dict[int, str] = {}
    for ev in doc["traceEvents"]:
        if ev["ph"] == "M" and ev["name"] == "thread_name":
            tracks[ev["tid"]] = ev["args"]["name"]
    records: List[SpanRecord] = []
    parsed_j = 0.0
    for ev in doc["traceEvents"]:
        if ev["ph"] not in ("X", "i") or "args" not in ev:
            continue
        args = dict(ev["args"])
        sid = args.pop("span_id", None)
        if sid is None:
            continue
        parent = args.pop("parent_id", None)
        t0 = ev["ts"] / _US
        t1 = t0 + ev.get("dur", 0.0) / _US
        parsed_j += args.get("energy_j", 0.0) if "window" in args \
            or "windows" in args else 0.0
        records.append(SpanRecord(
            span_id=int(sid), parent_id=None if parent is None
            else int(parent), name=ev["name"],
            track=tracks.get(ev["tid"], str(ev["tid"])), t0=t0, t1=t1,
            attrs=args))
    records.sort(key=lambda r: (r.t0, r.span_id))
    summary = dict(doc.get("otherData", {}))
    summary["parsed_attributed_j"] = parsed_j
    return records, summary


# ---------------------------------------------------------------------------
# replay: a recorded .dkt trace into the same timeline


def timeline_from_trace(reader, stream_id: Optional[int] = None,
                        meta: Optional[Dict] = None) -> Dict:
    """Rebuild the timeline of a recorded serving run (``record_engine``).

    One phase span per typed telemetry event, placed at the recorded
    session cursor, with that event's window energy read from the recorded
    sample chunk — chunk ``k`` of the stream *is* session window ``k``
    (the ``TelemetryEvent.window`` invariant), so the replayed timeline
    carries exactly the joules the live run measured.
    """
    events = [coerce_event(e) for e in reader.meta.get("events", [])]
    if not events:
        raise ValueError(
            f"{reader.path} has no telemetry event log — record the run "
            f"with tracestore.recorder.record_engine")
    sid = stream_id if stream_id is not None else reader.stream_ids()[0]
    blocks = list(reader.blocks(sid))
    energies = [b.energy_j() for b in blocks]
    walls = [b.duration_s() for b in blocks]
    spans: List[SpanRecord] = []
    cursor = 0.0
    for i, ev in enumerate(events):
        w = ev.window if ev.window >= 0 else i
        t0 = ev.t0 if ev.t0 > 0 or i == 0 else cursor
        attrs = {"window": w, "n_tokens": ev.n_tokens,
                 "requests": sorted({rid for ids in ev.groups.values()
                                     for rid in ids})}
        attrs.update(ev.extra)
        spans.append(SpanRecord(span_id=i, parent_id=None, name=ev.phase,
                                track="engine", t0=t0, t1=t0 + ev.wall_s,
                                attrs=attrs))
        cursor = t0 + ev.wall_s
    m = {"process": "dalek-replay", "trace_path": str(reader.path)}
    m.update(meta or {})
    return chrome_trace(spans, energies, walls, meta=m)
