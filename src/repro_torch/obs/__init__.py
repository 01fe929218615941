"""Observability for the port: a small copy of ``repro.obs``.

``REGISTRY`` is the process-wide metrics registry; ``default_tracer()``
the ring-only tracer used when a caller supplies none. The engine emits
the reference's spans (``serve.tick``, ``serve.prefill``,
``serve.decode``) and its dense snapshot key set, the trainer the
reference's ``train.step`` / ``train.repack`` / ``train.metrics``
events (``obs.schema``).
"""
from __future__ import annotations

from repro_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.schema import (  # noqa: F401
    TRAIN_FINAL_KEYS,
    TRAIN_STEP_EVENT_KEYS,
    drain_keys,
    snapshot_keys,
)
from repro_torch.obs.trace import Tracer  # noqa: F401

REGISTRY = MetricsRegistry()

_DEFAULT_TRACER = Tracer()


def default_tracer() -> Tracer:
    return _DEFAULT_TRACER
