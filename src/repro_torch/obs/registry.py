"""Counters and histograms with labeled series.

A small copy of ``repro.obs.registry`` (the port imports nothing of the
reference package): Prometheus semantics and idempotent registration;
snapshots and the text exposition are not ported yet (ROADMAP A14).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Sequence, Tuple

DEFAULT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, lock: threading.RLock):
        self.name = name
        self.help = help
        self._series: Dict[Tuple[Tuple[str, str], ...], Any] = {}
        self._lock = lock


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
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

    def observe(self, value: float, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            st = self._series.setdefault(
                key, {"buckets": [0] * len(self.buckets), "sum": 0.0,
                      "count": 0})
            for i, b in enumerate(self.buckets):
                if value <= b:
                    st["buckets"][i] += 1
            st["sum"] += value
            st["count"] += 1


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

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, buckets=buckets)
