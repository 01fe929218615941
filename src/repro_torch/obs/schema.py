"""The serving snapshot key sets: a copy of the dense and paged parts of
``repro.obs.schema``. The port's ``ServeEngine.metrics_snapshot()``
emits exactly ``snapshot_keys(paged)`` (a test holds it to the
reference's sets), and ``run_until_drained`` adds ``DRAIN_EXTRA_KEYS``.
Speculative keys come with that mode (ROADMAP A11)."""
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

#: additional keys when ``paged=True`` (the KVPagePool view)
SNAPSHOT_KEYS_PAGED = frozenset({
    "kv_page_size", "kv_pool_pages",
    "pool_utilization", "pool_peak_utilization",
    "pool_pages_used", "pool_pages_reserved", "pool_pages_free",
    "prefix_hit_rate", "prefix_hits", "prefix_queries",
    "pool_alloc_total", "pool_free_total", "pool_retain_total",
    "pool_evict_total", "pool_reserve_total", "pool_release_total",
    "cow_copies", "table_uploads", "table_upload_bytes",
    "table_rows_uploaded", "paged_attn",
    "kv_pages_read", "kv_pages_read_dense_equiv", "kv_pages_read_bytes",
})

DRAIN_EXTRA_KEYS = frozenset({"wall_s"})


def snapshot_keys(paged: bool = False) -> frozenset:
    """The exact ``metrics_snapshot()`` key set of an engine mode."""
    return SNAPSHOT_KEYS_BASE | (SNAPSHOT_KEYS_PAGED if paged
                                 else frozenset())


def drain_keys(paged: bool = False) -> frozenset:
    return snapshot_keys(paged) | DRAIN_EXTRA_KEYS
