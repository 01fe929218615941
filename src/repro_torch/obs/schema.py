"""The serving snapshot and training event key sets: a copy of those
parts of ``repro.obs.schema``. The port's ``ServeEngine.metrics_snapshot()``
emits exactly ``snapshot_keys(paged)`` and ``SpeculativeEngine``'s
``snapshot_keys(paged, speculative=True)`` (tests hold them to the
reference's sets); ``run_until_drained`` adds ``DRAIN_EXTRA_KEYS``, and
``DRAIN_EXTRA_KEYS_ADAPTIVE`` when the draft controller is on."""
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

#: additional keys on a ``SpeculativeEngine``
SNAPSHOT_KEYS_SPECULATIVE = frozenset({
    "k", "initial_k", "draft_bits", "draft_kv_bits",
    "spec_ticks", "slot_ticks", "proposed", "accepted",
    "acceptance_rate", "acceptance_ewma", "post_retune_acceptance",
    "committed_per_tick", "committed_per_slot_tick",
    "retunes",
    "draft_weight_passes",
    "draft_weight_read_bytes_fused", "draft_weight_read_bytes_dense",
    "draft_fused_bytes_per_pass", "draft_fused_analytic_bytes_per_pass",
    "draft_kv_bytes_appended",
})

DRAIN_EXTRA_KEYS = frozenset({"wall_s"})

#: required attrs of a ``train.step`` event (packed-master runs add
#: ``packed_staleness`` at log_every boundaries)
TRAIN_STEP_EVENT_KEYS = frozenset({"step", "loss", "step_time_s"})

#: attrs of the final ``train.metrics`` event
TRAIN_FINAL_KEYS = frozenset({
    "steps_completed", "last_step", "final_loss", "mean_step_time_s",
    "repacks", "straggler_events",
    "weight_passes", "weight_read_bytes_fused", "weight_read_bytes_dense",
    "fused_analytic_bytes_per_pass",
})
#: further drain extras when the adaptive controller is on
DRAIN_EXTRA_KEYS_ADAPTIVE = frozenset({"adaptive", "retune_events"})


def snapshot_keys(paged: bool = False,
                  speculative: bool = False) -> frozenset:
    """The exact ``metrics_snapshot()`` key set of an engine mode."""
    keys = SNAPSHOT_KEYS_BASE
    if paged:
        keys = keys | SNAPSHOT_KEYS_PAGED
    if speculative:
        keys = keys | SNAPSHOT_KEYS_SPECULATIVE
    return keys


def drain_keys(paged: bool = False, speculative: bool = False,
               adaptive: bool = False) -> frozenset:
    """The exact ``run_until_drained`` stats key set of an engine mode."""
    keys = snapshot_keys(paged, speculative) | DRAIN_EXTRA_KEYS
    if adaptive:
        keys = keys | DRAIN_EXTRA_KEYS_ADAPTIVE
    return keys
