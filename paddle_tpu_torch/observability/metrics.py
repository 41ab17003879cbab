"""Process-wide metrics registry — counters, gauges, histograms with labels.

The port's copy of ``paddle_tpu/observability/metrics.py``, unchanged in
behaviour, so the two packages' Prometheus text is identical for the same
sequence of operations.  ONE registry owns every runtime series the
serving engine, the supervisor and the gateway record.  The shape of the
API follows the Prometheus client convention (metric → labeled child →
inc/set/observe) because that is the export format operators already
parse: ``to_prometheus_text()`` is scrape-ready, ``dump()`` is the JSON
twin.

Time-series samples: when sampling is enabled (telemetry on), counter and
gauge updates append (ts, name, labels, value) into a bounded ring.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque

# default latency buckets (seconds) — from a decode step (~1 ms) to a
# cold engine build (~100 s)
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)


def _label_key(labels: dict | None) -> tuple:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Base: one named family holding children keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", registry=None):
        self.name = name
        self.help = help
        self._children: dict[tuple, object] = {}
        self._lock = threading.Lock()
        self._registry = registry

    def _child(self, labels, default):
        key = _label_key(labels)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = default()
            return child

    def _sample(self, labels, value):
        reg = self._registry
        if reg is not None and reg.sampling:
            reg.record_sample(self.name, value, labels)

    def series(self):
        """[(labels-dict, child), ...] snapshot."""
        with self._lock:
            return [(dict(k), v) for k, v in self._children.items()]

    def remove(self, labels: dict | None = None) -> bool:
        """Delete one labeled series (True if it existed).  For series
        keyed by a dynamic entity — an engine replica, an adapter — the
        entity's removal must delete its series, not freeze it at the
        last value: a dashboard showing a dead replica's stale occupancy
        is a mis-diagnosis trap."""
        with self._lock:
            return self._children.pop(_label_key(labels), None) is not None


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, labels: dict | None = None):
        if value < 0:
            raise ValueError("counters only go up")
        key = _label_key(labels)
        with self._lock:
            new = self._children.get(key, 0.0) + value
            self._children[key] = new
        self._sample(labels, new)
        return new

    def value(self, labels: dict | None = None) -> float:
        with self._lock:
            return self._children.get(_label_key(labels), 0.0)

    def total(self) -> float:
        """Sum over every label combination."""
        with self._lock:
            return float(sum(self._children.values()))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, labels: dict | None = None):
        with self._lock:
            self._children[_label_key(labels)] = float(value)
        self._sample(labels, float(value))

    def inc(self, value: float = 1.0, labels: dict | None = None):
        key = _label_key(labels)
        with self._lock:
            new = self._children.get(key, 0.0) + value
            self._children[key] = new
        self._sample(labels, new)

    def dec(self, value: float = 1.0, labels: dict | None = None):
        self.inc(-value, labels)

    def value(self, labels: dict | None = None) -> float:
        with self._lock:
            return self._children.get(_label_key(labels), 0.0)


class _HistValue:
    __slots__ = ("buckets", "counts", "count", "sum")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * len(buckets)
        self.count = 0
        self.sum = 0.0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS, registry=None):
        super().__init__(name, help, registry)
        self.buckets = tuple(sorted(buckets))

    def observe(self, value: float, labels: dict | None = None):
        h = self._child(labels, lambda: _HistValue(self.buckets))
        with self._lock:
            h.count += 1
            h.sum += float(value)
            # cumulative bucket counts, the prometheus convention:
            # counts[i] = observations <= buckets[i]
            for i, le in enumerate(self.buckets):
                if value <= le:
                    h.counts[i] += 1

    def snapshot(self, labels: dict | None = None) -> dict:
        """{count, sum, buckets: {le: cumulative count}}."""
        with self._lock:
            h = self._children.get(_label_key(labels))
            if h is None:
                return {"count": 0, "sum": 0.0, "buckets": {}}
            return {"count": h.count, "sum": h.sum,
                    "buckets": {str(le): c
                                for le, c in zip(self.buckets, h.counts)}}

    def count(self, labels: dict | None = None) -> int:
        with self._lock:
            h = self._children.get(_label_key(labels))
            return h.count if h else 0

    def total_count(self) -> int:
        with self._lock:
            return sum(h.count for h in self._children.values())


class MetricsRegistry:
    """Named metric families + the chrome-trace sample ring."""

    def __init__(self, max_samples: int = 8192):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self.sampling = False
        self._samples: deque = deque(maxlen=max_samples)

    # -- registration --------------------------------------------------------
    def _register(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}")
                return m
            m = cls(name, help, registry=self, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> _Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def reset(self):
        """Drop every series and sample (bench uses this between legs)."""
        with self._lock:
            self._metrics.clear()
            self._samples.clear()

    # -- chrome-trace samples ------------------------------------------------
    def record_sample(self, name, value, labels=None, ts=None):
        self._samples.append({
            "name": name, "value": float(value),
            "labels": dict(labels) if labels else {},
            "ts": time.perf_counter() * 1e6 if ts is None else ts})

    def samples(self) -> list[dict]:
        return list(self._samples)

    # -- export --------------------------------------------------------------
    def dump(self) -> dict:
        """JSON-ready snapshot: {kind: {name: [{labels, ...}, ...]}}."""
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            if isinstance(m, Histogram):
                out["histograms"][m.name] = [
                    {"labels": labels, **m.snapshot(labels)}
                    for labels, _ in m.series()]
            elif isinstance(m, Counter):
                out["counters"][m.name] = [
                    {"labels": labels, "value": v} for labels, v in m.series()]
            elif isinstance(m, Gauge):
                out["gauges"][m.name] = [
                    {"labels": labels, "value": v} for labels, v in m.series()]
        return out

    def to_json(self) -> str:
        return json.dumps(self.dump(), sort_keys=True)

    def to_prometheus_text(self) -> str:
        """Prometheus exposition text format (scrape-ready)."""
        def fmt_labels(labels: dict, extra: dict | None = None) -> str:
            items = dict(labels)
            if extra:
                items.update(extra)
            if not items:
                return ""
            body = ",".join(f'{k}="{v}"' for k, v in sorted(items.items()))
            return "{" + body + "}"

        lines = []
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                for labels, _ in m.series():
                    snap = m.snapshot(labels)
                    for le in m.buckets:
                        lines.append(
                            f"{m.name}_bucket"
                            f"{fmt_labels(labels, {'le': le})} "
                            f"{snap['buckets'].get(str(le), 0)}")
                    lines.append(
                        f"{m.name}_bucket{fmt_labels(labels, {'le': '+Inf'})}"
                        f" {snap['count']}")
                    lines.append(
                        f"{m.name}_sum{fmt_labels(labels)} {snap['sum']}")
                    lines.append(
                        f"{m.name}_count{fmt_labels(labels)} {snap['count']}")
            else:
                for labels, v in m.series():
                    lines.append(f"{m.name}{fmt_labels(labels)} {v}")
        return "\n".join(lines) + "\n"
