"""Counters, gauges and histograms with labeled series.

A copy of ``repro.obs.registry`` (the port imports nothing of the
reference package). Semantics follow Prometheus: a counter only
increases, a gauge holds the last set value, a histogram accumulates
observations into cumulative buckets plus a sum and a count. Each metric
owns a family of labeled series; the empty label set is a valid series.
Registration is idempotent, and a name registered as one type raises
when asked for as another. ``MetricsRegistry.snapshot()`` gives the
whole registry as a plain JSON-ready dict, ``expose()`` as the
Prometheus text exposition (character for character the reference's).
"""
from __future__ import annotations

import math
import re
import threading
from typing import Any, Dict, List, Sequence, Tuple

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_LABEL_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")

DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return (value.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt(v: float) -> str:
    """A sample value: integers bare, other floats as repr."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v != int(v):
        return repr(v)
    return str(int(v))


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.RLock):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help
        self._series: Dict[Tuple[Tuple[str, str], ...], Any] = {}
        self._lock = lock

    def _key(self, labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        return _label_key(labels)

    def series(self) -> List[Tuple[Dict[str, str], Any]]:
        with self._lock:
            return [(dict(k), v) for k, v in sorted(self._series.items())]


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)


class Gauge(_Metric):
    """Last-write-wins sample (a loss, an occupancy, an EWMA)."""

    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = value

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0) + value

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.RLock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, lock)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")

    def observe(self, value: float, **labels: Any) -> None:
        key = self._key(labels)
        with self._lock:
            st = self._series.setdefault(
                key, {"buckets": [0] * len(self.buckets), "sum": 0.0,
                      "count": 0})
            for i, b in enumerate(self.buckets):
                if value <= b:
                    st["buckets"][i] += 1
            st["sum"] += value
            st["count"] += 1

    def stats(self, **labels: Any) -> Dict[str, Any]:
        with self._lock:
            st = self._series.get(_label_key(labels))
            if st is None:
                return {"buckets": [0] * len(self.buckets), "sum": 0.0,
                        "count": 0}
            return {"buckets": list(st["buckets"]), "sum": st["sum"],
                    "count": st["count"]}


class MetricsRegistry:
    """Name -> metric map; asking for an existing name returns it, and a
    different type under the same name raises."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, self._lock, **kw)
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{m.kind}, not {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._register(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._register(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    def reset(self) -> None:
        """Drop every metric (tests; never on the serving path)."""
        with self._lock:
            self._metrics.clear()

    # -- exporters ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """The whole registry as a plain JSON-ready dict: per metric its
        type, help and labeled series."""
        out: Dict[str, Any] = {}
        for m in self.metrics():
            series = []
            for labels, val in m.series():
                if m.kind == "histogram":
                    series.append({
                        "labels": labels,
                        "buckets": dict(zip((_fmt(b) for b in m.buckets),
                                            val["buckets"])),
                        "sum": val["sum"],
                        "count": val["count"],
                    })
                else:
                    series.append({"labels": labels, "value": val})
            out[m.name] = {"type": m.kind, "help": m.help, "series": series}
        return out

    def expose(self) -> str:
        """Prometheus text exposition (text/plain; version 0.0.4)."""
        lines: List[str] = []
        for m in self.metrics():
            if m.help:
                lines.append(f"# HELP {m.name} {_escape(m.help)}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for labels, val in m.series():
                if m.kind != "histogram":
                    lines.append(f"{m.name}{_label_str(labels)} {_fmt(val)}")
                    continue
                for b, c in zip(m.buckets, val["buckets"]):
                    lab = dict(labels, le=_fmt(b))
                    lines.append(f"{m.name}_bucket{_label_str(lab)} {c}")
                inf = dict(labels, le="+Inf")
                lines.append(
                    f"{m.name}_bucket{_label_str(inf)} {val['count']}")
                lines.append(
                    f"{m.name}_sum{_label_str(labels)} {_fmt(val['sum'])}")
                lines.append(
                    f"{m.name}_count{_label_str(labels)} {val['count']}")
        return "\n".join(lines) + ("\n" if lines else "")
