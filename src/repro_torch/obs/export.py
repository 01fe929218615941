"""Exporters: JSONL reading and the console summary table.

A copy of ``repro.obs.export``. The other two export formats live with
their data: the Prometheus text exposition is
``MetricsRegistry.expose()`` and the JSONL event stream is
``Tracer.set_sink``. This module holds the read side (``read_jsonl``)
and the operator's view (``console_summary``).
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterator, List

from repro_torch.obs.registry import MetricsRegistry


def read_jsonl(path: str) -> Iterator[Dict[str, Any]]:
    """One record per non-empty line; a malformed line raises (a metrics
    stream with broken lines is a bug, not noise to skip)."""
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"{path}:{i + 1}: malformed JSONL record: {e}") from e


def console_summary(registry: MetricsRegistry) -> str:
    """Aligned name / labels / value / type table over the registry, for
    launcher exits and CI logs. Histograms summarize to count and mean;
    an infinite gauge shows as inf (the reference's table raises)."""
    rows: List[List[str]] = []
    for m in registry.metrics():
        for labels, val in m.series():
            lab = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            if m.kind == "histogram":
                n = val["count"]
                mean = val["sum"] / n if n else 0.0
                cell = f"count={n} mean={mean:.6g}"
            elif isinstance(val, float) and not (math.isfinite(val)
                                                 and val == int(val)):
                cell = f"{val:.6g}"
            else:
                cell = str(int(val))
            rows.append([m.name, lab, cell, m.kind])
    if not rows:
        return "(no metrics recorded)\n"
    head = ["metric", "labels", "value", "type"]
    widths = [max(len(r[c]) for r in rows + [head]) for c in range(4)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(head, widths)),
             "  ".join("-" * w for w in widths)]
    lines += ["  ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows]
    return "\n".join(lines) + "\n"
