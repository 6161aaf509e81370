"""Labeled metrics registry: Counter / Gauge / Histogram.

Replaces the engines' ad-hoc run-stats dicts with one instrumented store
that every layer (serve, train, cluster) shares:

    m = MetricsRegistry()
    m.counter("tokens_decoded").inc(8)
    m.counter("requests_finished", "requests by finish reason").inc(
        reason="eos")
    m.gauge("queue_depth").set(3)
    m.histogram("decode_step_s").observe(0.0123)

Snapshots are **deterministic**: ``snapshot()`` orders metrics and label
sets lexicographically and ``to_json()`` serializes with sorted keys and
fixed separators, so two identical runs produce byte-identical output (a
tested invariant — diffs of metrics dumps are signal, never churn).
``prometheus()`` renders the standard text exposition format for scraping.

Floats are emitted as-is (no rounding): determinism comes from identical
arithmetic on identical runs, not from lossy formatting.
"""
from __future__ import annotations

import bisect
import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]

LabelKey = Tuple[Tuple[str, str], ...]

#: default histogram buckets (seconds-flavored, exponential)
DEFAULT_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _label_key(labels: Dict[str, object]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: LabelKey) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()


class Counter(_Metric):
    """Monotonically increasing per-label-set totals."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}

    def inc(self, value: float = 1.0, **labels):
        if value < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def total(self) -> float:
        """Sum across all label sets."""
        with self._lock:
            return sum(self._values.values())

    def _rows(self):
        return [(key, {"value": v})
                for key, v in sorted(self._values.items())]


class Gauge(_Metric):
    """Point-in-time values (queue depth, free blocks, watts)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[LabelKey, float] = {}

    def set(self, value: float, **labels):
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def add(self, value: float, **labels):
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def _rows(self):
        return [(key, {"value": v})
                for key, v in sorted(self._values.items())]


class Histogram(_Metric):
    """Cumulative-bucket distribution (Prometheus semantics: ``le`` buckets
    count observations <= the edge, plus ``+Inf``, sum, and count)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        edges = sorted(float(b) for b in buckets)
        if not edges:
            raise ValueError(f"histogram {self.name}: no buckets")
        self.edges = edges
        self._counts: Dict[LabelKey, List[int]] = {}   # per-edge (+Inf last)
        self._sum: Dict[LabelKey, float] = {}
        self._n: Dict[LabelKey, int] = {}

    def observe(self, value: float, **labels):
        key = _label_key(labels)
        i = bisect.bisect_left(self.edges, float(value))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * (len(self.edges) + 1))
            counts[i] += 1
            self._sum[key] = self._sum.get(key, 0.0) + float(value)
            self._n[key] = self._n.get(key, 0) + 1

    def count(self, **labels) -> int:
        with self._lock:
            return self._n.get(_label_key(labels), 0)

    def sum(self, **labels) -> float:
        with self._lock:
            return self._sum.get(_label_key(labels), 0.0)

    def _rows(self):
        out = []
        for key in sorted(self._counts):
            cum, buckets = 0, {}
            for edge, c in zip(self.edges, self._counts[key]):
                cum += c
                buckets[repr(edge)] = cum
            buckets["+Inf"] = cum + self._counts[key][-1]
            out.append((key, {"buckets": buckets, "sum": self._sum[key],
                              "count": self._n[key]}))
        return out


class MetricsRegistry:
    """Get-or-create store of named metrics; the unit every subsystem
    instruments against and every snapshot/exposition reads from."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._metrics

    # -- snapshots ------------------------------------------------------------

    def snapshot(self) -> Dict:
        """Deterministic nested dict: metric name -> {kind, help, series}
        with series keyed by the canonical label string."""
        out: Dict = {}
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            with m._lock:
                rows = m._rows()
            out[name] = {"kind": m.kind, "help": m.help,
                         "series": {_label_str(k) or "{}": v
                                    for k, v in rows}}
            if isinstance(m, Histogram):
                out[name]["bucket_edges"] = [repr(e) for e in m.edges]
        return out

    def to_json(self) -> str:
        """Byte-deterministic JSON dump of :meth:`snapshot`."""
        return json.dumps(self.snapshot(), sort_keys=True,
                          separators=(",", ":"))

    def write_json(self, path) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return str(path)

    def prometheus(self) -> str:
        """Prometheus text exposition (``# HELP``/``# TYPE`` + samples)."""
        lines: List[str] = []
        with self._lock:
            metrics = sorted(self._metrics.items())
        for name, m in metrics:
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            with m._lock:
                rows = m._rows()
            for key, row in rows:
                if m.kind == "histogram":
                    for edge, cum in row["buckets"].items():
                        le = (key + (("le", edge),))
                        lines.append(f"{name}_bucket{_label_str(le)} {cum}")
                    lines.append(f"{name}_sum{_label_str(key)} {row['sum']}")
                    lines.append(
                        f"{name}_count{_label_str(key)} {row['count']}")
                else:
                    lines.append(f"{name}{_label_str(key)} {row['value']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def clear(self):
        """Drop every metric (benchmark warmup reset)."""
        with self._lock:
            self._metrics = {}
