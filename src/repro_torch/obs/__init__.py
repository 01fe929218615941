"""Observability for the port: a copy of ``repro.obs``.

``REGISTRY`` is the process-wide metrics registry (``snapshot()`` as a
JSON-ready dict, ``expose()`` as the Prometheus text exposition);
``default_tracer()`` the ring-only tracer used when a caller supplies
none, and launchers attach a JSONL sink to a fresh tracer for
``--metrics-out``. The engine emits the reference's spans
(``serve.tick``, ``serve.prefill``, ``serve.decode``) and
``serve.metrics`` snapshots, the trainer the reference's ``train.step``
/ ``train.repack`` / ``train.metrics`` events (``obs.schema``, whose
``validate_metrics_jsonl`` checks such a stream; ``python -m
repro_torch.obs.validate`` on the command line; ``--lint`` checks the
reports of ``repro_torch.analysis`` with ``validate_lint_report``).
``console_summary`` renders the registry as a table, ``read_jsonl``
reads a stream back.
"""
from __future__ import annotations

from repro_torch.obs.export import console_summary, read_jsonl  # noqa: F401
from repro_torch.obs.registry import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.schema import (  # noqa: F401
    LINT_FINDING_KEYS,
    LINT_REPORT_KEYS,
    TRAIN_FINAL_KEYS,
    TRAIN_STEP_EVENT_KEYS,
    check_byte_parity,
    drain_keys,
    snapshot_keys,
    validate_lint_report,
    validate_metrics_jsonl,
)
from repro_torch.obs.trace import Tracer  # noqa: F401

REGISTRY = MetricsRegistry()

_DEFAULT_TRACER = Tracer()


def default_tracer() -> Tracer:
    return _DEFAULT_TRACER
