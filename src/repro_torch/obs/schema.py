"""The serving snapshot key set: a copy of the dense-mode part of
``repro.obs.schema``. The port's ``ServeEngine.metrics_snapshot()``
emits exactly ``SNAPSHOT_KEYS_BASE`` (a test holds it to the
reference's set), and ``run_until_drained`` adds ``DRAIN_EXTRA_KEYS``.
Paged and speculative keys come with those modes (ROADMAP A10, A11)."""
from __future__ import annotations

SNAPSHOT_KEYS_BASE = frozenset({
    "ticks", "tokens", "slots",
    "active_requests", "queued_requests", "finished_requests",
    "admitted_requests", "admission_wait_s_mean",
    "slot_occupancy",
    "residency_max_sequences", "arithmetic_intensity",
    "decode_calls", "prefill_calls",
    "weight_passes",
    "weight_read_bytes_fused", "weight_read_bytes_dense",
    "fused_bytes_per_pass", "fused_analytic_bytes_per_pass",
    "fused_f32_bytes_per_pass", "dense_bytes_per_pass",
    "kv_rows_appended", "kv_rows_committed", "kv_bytes_appended",
})

DRAIN_EXTRA_KEYS = frozenset({"wall_s"})


def snapshot_keys() -> frozenset:
    """The exact dense-mode ``metrics_snapshot()`` key set."""
    return SNAPSHOT_KEYS_BASE


def drain_keys() -> frozenset:
    return SNAPSHOT_KEYS_BASE | DRAIN_EXTRA_KEYS
