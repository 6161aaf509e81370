"""Request-lifecycle and engine-step spans.

A :class:`Tracer` records nested, monotonic-clock spans into a thread-safe
ring buffer. Two usage shapes:

    with tracer.span("decode_step", queue_depth=3) as sp:
        ...                          # lexical: one engine step
        sp.set("window", idx)

    h = tracer.begin("queued", track="req7")    # non-lexical: a request's
    ...                                          # life crosses many steps
    h.end(finish_reason="eos")

Lexical spans MUST use the ``with`` form and non-lexical handles MUST be
ended on every path — dalek-lint DLK007 (``unclosed-span``) enforces both
statically.

Spans are cheap on purpose: beginning/ending a span is a clock read plus a
few attribute writes under a lock that is only contended when engines share
a tracer across threads. The serving bench gates the overhead (<5% decode
tokens/s with spans on vs off).

Attribute conventions the exporter understands:

``window``   index of the ``MonitorSession`` sample window this span's
             compute was measured in (see ``obs.events``). The exporter
             assigns that window's joules to the span — every window is
             referenced by exactly one span, so per-span energy sums to the
             session report total exactly.
``track``    timeline row: "engine" (default) for step spans, "req<N>" for
             request-lifecycle spans.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["Span", "SpanRecord", "Tracer"]


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    """One finished span (immutable; what ``Tracer.spans()`` returns)."""

    span_id: int
    parent_id: Optional[int]
    name: str
    track: str
    t0: float                       # seconds since tracer epoch
    t1: float
    attrs: Dict[str, object]

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


class Span:
    """A live span. Use as a context manager (lexical) or keep the handle
    and call :meth:`end` exactly once (non-lexical)."""

    __slots__ = ("_tracer", "span_id", "parent_id", "name", "track",
                 "t0", "_attrs", "_ended")

    def __init__(self, tracer: "Tracer", span_id: int,
                 parent_id: Optional[int], name: str, track: str,
                 t0: float, attrs: Dict[str, object]):
        self._tracer = tracer
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.track = track
        self.t0 = t0
        self._attrs = attrs
        self._ended = False

    def set(self, key: str, value) -> "Span":
        """Attach/overwrite one attribute (chainable)."""
        self._attrs[key] = value
        return self

    def update(self, **attrs) -> "Span":
        self._attrs.update(attrs)
        return self

    def end(self, **attrs):
        """Finish the span; extra ``attrs`` merge in. Idempotent so an
        exception path and a normal path may both reach it."""
        if self._ended:
            return
        self._ended = True
        self._attrs.update(attrs)
        self._tracer._finish(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self._attrs.setdefault("error", exc_type.__name__)
        self.end()
        return False


class _NullSpan:
    """No-op span so call sites need no ``if tracer`` guards on ``set``."""

    __slots__ = ()

    def set(self, key, value):
        return self

    def update(self, **attrs):
        return self

    def end(self, **attrs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Thread-safe span recorder over a bounded ring buffer.

    The clock is ``time.perf_counter`` rebased to the tracer's creation
    (monotonic, never wall time). Nesting is tracked per thread: a span
    begun while another is open on the same thread records it as parent.
    When the ring fills, the *oldest* finished spans are dropped and
    ``n_dropped`` counts them — a long-running engine keeps the most recent
    window of history instead of growing without bound.
    """

    def __init__(self, capacity: int = 65536, clock=time.perf_counter):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._clock = clock
        self._epoch = clock()
        self._lock = threading.Lock()
        self._done: List[SpanRecord] = []
        self._next_id = 0
        self._n_dropped = 0
        self._n_started = 0
        self._stacks = threading.local()

    # -- clock ---------------------------------------------------------------

    def now(self) -> float:
        """Seconds since the tracer epoch."""
        return self._clock() - self._epoch

    # -- span creation -------------------------------------------------------

    def _stack(self) -> List[int]:
        st = getattr(self._stacks, "ids", None)
        if st is None:
            st = self._stacks.ids = []
        return st

    def span(self, name: str, track: str = "engine", **attrs) -> Span:
        """Open a lexical span — always use as ``with tracer.span(...)``
        (DLK007 flags any other shape)."""
        return self._begin(name, track, attrs, push=True)

    def begin(self, name: str, track: str = "engine", **attrs) -> Span:
        """Open a non-lexical span handle; the caller owns ending it.
        Does not join the thread's nesting stack — a request's lifecycle
        span is not the parent of unrelated engine steps that happen to
        run while it is queued."""
        return self._begin(name, track, attrs, push=False)

    def _begin(self, name, track, attrs, push: bool) -> Span:
        stack = self._stack()
        parent = stack[-1] if (push and stack) else None
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._n_started += 1
        sp = Span(self, sid, parent, name, track, self.now(), dict(attrs))
        if push:
            stack.append(sid)
        return sp

    def instant(self, name: str, track: str = "engine", **attrs):
        """Zero-duration marker (e.g. a request's ``finish`` event)."""
        t = self.now()
        self._record(SpanRecord(span_id=self._take_id(), parent_id=None,
                                name=name, track=track, t0=t, t1=t,
                                attrs=dict(attrs)))

    def _take_id(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
            self._n_started += 1
            return sid

    # -- completion ----------------------------------------------------------

    def _finish(self, span: Span):
        stack = self._stack()
        if stack and stack[-1] == span.span_id:
            stack.pop()
        self._record(SpanRecord(
            span_id=span.span_id, parent_id=span.parent_id, name=span.name,
            track=span.track, t0=span.t0, t1=self.now(),
            attrs=span._attrs))

    def _record(self, rec: SpanRecord):
        with self._lock:
            self._done.append(rec)
            if len(self._done) > self.capacity:
                drop = len(self._done) - self.capacity
                del self._done[:drop]
                self._n_dropped += drop

    # -- inspection ----------------------------------------------------------

    def spans(self) -> List[SpanRecord]:
        """Finished spans, oldest first (start-time order)."""
        with self._lock:
            out = list(self._done)
        out.sort(key=lambda r: (r.t0, r.span_id))
        return out

    @property
    def n_dropped(self) -> int:
        with self._lock:
            return self._n_dropped

    @property
    def n_started(self) -> int:
        with self._lock:
            return self._n_started

    def __len__(self) -> int:
        with self._lock:
            return len(self._done)

    def clear(self):
        """Drop recorded spans (benchmark warmup); ids and clock keep
        going so already-open handles still end cleanly."""
        with self._lock:
            self._done = []
            self._n_dropped = 0
            self._n_started = 0


def span_tree(records: List[SpanRecord]) -> Dict[Optional[int], List[SpanRecord]]:
    """parent_id -> children (start-time order); roots under ``None``."""
    out: Dict[Optional[int], List[SpanRecord]] = {}
    for r in sorted(records, key=lambda r: (r.t0, r.span_id)):
        out.setdefault(r.parent_id, []).append(r)
    return out
