"""Span and event records in a bounded ring.

A small copy of ``repro.obs.trace.Tracer``: the same record shape
``{"kind", "name", "ts", ("dur_s",) "attrs"}``, kept in a ring and, when
a sink is attached (``set_sink``; the train launcher's
``--metrics-out``), written to a JSONL file a record a line. Span durations are
host time; on the card they include the device's time only where the
spanned code waits for the device (a decode tick does, when it reads
back its tokens).
"""
from __future__ import annotations

import collections
import contextlib
import json
import threading
import time
from typing import IO, Any, Deque, Dict, List, Optional, Union


def _json_default(o: Any) -> Any:
    """Tensors and numpy scalars or arrays as plain JSON values."""
    if hasattr(o, "tolist"):
        return o.tolist()
    return str(o)


class Tracer:
    def __init__(self, ring_capacity: int = 4096,
                 sink: Union[None, str, IO[str]] = None):
        self._ring: Deque[Dict[str, Any]] = collections.deque(
            maxlen=ring_capacity)
        self._lock = threading.Lock()
        self._sink: Optional[IO[str]] = None
        self._owns_sink = False
        self.dropped = 0          # records the sink failed to take
        if sink is not None:
            self.set_sink(sink)

    # -- sink management --------------------------------------------------
    def set_sink(self, sink: Union[str, IO[str]]) -> None:
        """Attach a JSONL sink: a path (opened, truncated, line-buffered)
        or an open text file."""
        self.close()
        if isinstance(sink, str):
            self._sink = open(sink, "w", buffering=1)
            self._owns_sink = True
        else:
            self._sink = sink
            self._owns_sink = False

    def flush(self) -> None:
        with self._lock:
            if self._sink is not None:
                self._sink.flush()

    def close(self) -> None:
        with self._lock:
            if self._sink is not None and self._owns_sink:
                self._sink.close()
            self._sink = None
            self._owns_sink = False

    def _emit(self, rec: Dict[str, Any]) -> None:
        with self._lock:
            self._ring.append(rec)
            if self._sink is not None:
                try:
                    self._sink.write(
                        json.dumps(rec, default=_json_default) + "\n")
                except (OSError, TypeError, ValueError):
                    self.dropped += 1

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
