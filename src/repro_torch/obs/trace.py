"""Span and event records in a bounded ring.

A small copy of ``repro.obs.trace.Tracer``: the same record shape
``{"kind", "name", "ts", ("dur_s",) "attrs"}``; the JSONL sink comes
with the launcher's ``--metrics-out`` (ROADMAP A14). Span durations are
host time; on the card they include the device's time only where the
spanned code waits for the device (a decode tick does, when it reads
back its tokens).
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Deque, Dict, List, Optional


class Tracer:
    def __init__(self, ring_capacity: int = 4096):
        self._ring: Deque[Dict[str, Any]] = collections.deque(
            maxlen=ring_capacity)
        self._lock = threading.Lock()

    def _emit(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(rec)

    def event(self, name: str, **attrs: Any) -> Dict[str, Any]:
        rec = {"kind": "event", "name": name, "ts": time.time(),
               "attrs": attrs}
        self._emit(rec)
        return rec

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any):
        """Timed record; mutate the yielded dict to attach late attrs."""
        live: Dict[str, Any] = dict(attrs)
        t0 = time.perf_counter()
        ts = time.time()
        yield live
        self._emit({"kind": "span", "name": name, "ts": ts,
                    "dur_s": time.perf_counter() - t0, "attrs": live})

    def events(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            recs = list(self._ring)
        return recs if name is None else [r for r in recs if r["name"] == name]
