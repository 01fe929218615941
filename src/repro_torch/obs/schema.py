"""The metrics and lint schemas: the key sets and the validators.

A copy of ``repro.obs.schema``. The port's
``ServeEngine.metrics_snapshot()`` emits exactly
``snapshot_keys(paged)`` and ``SpeculativeEngine``'s
``snapshot_keys(paged, speculative=True)`` (tests hold them to the
reference's sets); ``run_until_drained`` adds ``DRAIN_EXTRA_KEYS``, and
``DRAIN_EXTRA_KEYS_ADAPTIVE`` when the draft controller is on.

Byte accounting (the paper's saving as a live counter): a snapshot's
``weight_read_bytes_fused`` must equal ``weight_passes x
fused_analytic_bytes_per_pass`` (the bits/32 model summed per packed
leaf) within ``BYTE_TOLERANCE``; group-of-32 padding is the only slack.
``validate_metrics_jsonl`` holds a ``--metrics-out`` stream's final
snapshot to its mode's key set and to that invariant, for the target
and, when speculative, the draft.

The lint half: ``validate_lint_report`` holds a ``repro_torch.analysis
.lint --out`` report (or the reference's: the schema is the same) to
``LINT_REPORT_KEYS``, each finding to ``LINT_FINDING_KEYS``, and its
``clean`` and ``counters`` to a recount of its findings.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Tuple

BYTE_TOLERANCE = 0.01

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


#: top-level keys of a schema-v1 lint report
LINT_REPORT_KEYS = frozenset({
    "version", "arch", "clean", "passes", "findings", "counters",
    "kv_bits", "kv_bounds",
})

#: keys every serialized lint finding carries
LINT_FINDING_KEYS = frozenset({
    "check", "severity", "message", "path", "detail",
})


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


def check_byte_parity(snap: Dict[str, Any],
                      prefix: str = "") -> List[str]:
    """The fused byte counter against the analytic model on one snapshot;
    ``prefix`` "" for the target, "draft_" for the draft. Returns error
    strings (none when the invariant holds, or for an unpacked stream:
    a zero fused counter with zero analytic bytes is a dense run)."""
    passes = snap.get(f"{prefix}weight_passes", 0)
    got = snap.get(f"{prefix}weight_read_bytes_fused", 0)
    per_pass = snap.get(f"{prefix}fused_analytic_bytes_per_pass", 0)
    want = passes * per_pass
    if want == 0:
        if got != 0:
            return [f"{prefix}weight_read_bytes_fused={got} but the "
                    "analytic model predicts 0 (unpacked stream)"]
        return []
    rel = abs(got - want) / want
    if rel > BYTE_TOLERANCE:
        return [
            f"{prefix}weight_read_bytes_fused={got} deviates "
            f"{rel:.2%} from the analytic bits/32 model "
            f"({passes} passes x {per_pass} B = {want} B); "
            f"tolerance {BYTE_TOLERANCE:.0%}"]
    return []


def check_paged_pages_parity(snap: Dict[str, Any]) -> List[str]:
    """The paged-attention byte counter against the KV append stream: a
    page holds ``kv_page_size`` rows of ``kv_bytes_appended /
    kv_rows_appended`` bytes each, so ``kv_pages_read_bytes ==
    kv_pages_read x page_size x bytes/row`` within ``BYTE_TOLERANCE``.
    Skipped when the run read no pages through the table or appended
    no rows."""
    pages = snap.get("kv_pages_read", 0)
    rows = snap.get("kv_rows_appended", 0)
    if not snap.get("paged_attn") or not pages or not rows:
        return []
    per_row = snap.get("kv_bytes_appended", 0) / rows
    want = pages * snap.get("kv_page_size", 0) * per_row
    got = snap.get("kv_pages_read_bytes", 0)
    if want == 0:
        if got != 0:
            return [f"kv_pages_read_bytes={got} but the append stream "
                    "predicts 0 (dense KV rows)"]
        return []
    rel = abs(got - want) / want
    if rel > BYTE_TOLERANCE:
        return [
            f"kv_pages_read_bytes={got} deviates {rel:.2%} from the "
            f"append-stream model ({pages} pages x "
            f"{snap.get('kv_page_size', 0)} rows x {per_row:.1f} B = "
            f"{want:.0f} B); tolerance {BYTE_TOLERANCE:.0%}"]
    return []


def validate_metrics_jsonl(path: str) -> Tuple[Dict[str, int], List[str]]:
    """Validate one ``--metrics-out`` stream: every line a span or event
    record, at least one ``serve.metrics`` or ``train.metrics`` event,
    the last of them with exactly its mode's key set (the mode read off
    the keys), every ``train.step`` with its keys, and the byte
    invariants. Returns ``(counts, errors)``: counts of records, spans,
    events and metrics events; no errors means a valid stream."""
    errors: List[str] = []
    counts = {"records": 0, "spans": 0, "events": 0, "metrics_events": 0}
    last_serve: Dict[str, Any] = {}
    last_train: Dict[str, Any] = {}
    try:
        with open(path) as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError as e:
                    errors.append(f"line {i + 1}: malformed JSON: {e}")
                    continue
                counts["records"] += 1
                if not isinstance(rec, dict) or "kind" not in rec \
                        or "name" not in rec or "ts" not in rec:
                    errors.append(f"line {i + 1}: not a span/event record: "
                                  f"{str(rec)[:80]}")
                    continue
                kind = rec["kind"]
                counts["spans" if kind == "span" else "events"] += 1
                if kind == "span" and "dur_s" not in rec:
                    errors.append(f"line {i + 1}: span without dur_s")
                if rec["name"] == "serve.metrics":
                    counts["metrics_events"] += 1
                    last_serve = rec.get("attrs", {})
                elif rec["name"] == "train.metrics":
                    counts["metrics_events"] += 1
                    last_train = rec.get("attrs", {})
                elif rec["name"] == "train.step":
                    missing = TRAIN_STEP_EVENT_KEYS - set(
                        rec.get("attrs", {}))
                    if missing:
                        errors.append(f"line {i + 1}: train.step missing "
                                      f"{sorted(missing)}")
    except OSError as e:
        return counts, [f"cannot read {path}: {e}"]

    if counts["records"] == 0:
        errors.append("empty metrics stream")
        return counts, errors
    if counts["metrics_events"] == 0:
        errors.append("no serve.metrics / train.metrics event in stream")
        return counts, errors
    if last_serve:
        paged = "kv_page_size" in last_serve
        spec = "k" in last_serve
        want = snapshot_keys(paged, spec)
        got = set(last_serve)
        mode = f"paged={paged} speculative={spec}"
        if want - got:
            errors.append(f"serve.metrics [{mode}] missing keys: "
                          f"{sorted(want - got)}")
        if got - want:
            errors.append(f"serve.metrics [{mode}] unexpected keys: "
                          f"{sorted(got - want)}")
        errors.extend(check_byte_parity(last_serve))
        if paged:
            errors.extend(check_paged_pages_parity(last_serve))
        if spec:
            errors.extend(check_byte_parity(last_serve, "draft_"))
    if last_train:
        missing = TRAIN_FINAL_KEYS - set(last_train)
        if missing:
            errors.append(f"train.metrics missing keys: {sorted(missing)}")
        errors.extend(check_byte_parity(last_train))
    return counts, errors


def validate_lint_report(path: str) -> Tuple[Dict[str, int], List[str]]:
    """Validate one lint report artifact.

    Checks the exact schema-v1 key set, the finding record shape, that
    ``clean`` agrees with the findings (a report claiming clean while
    carrying an error finding is itself a failure), and that ``counters``
    matches a recount. Returns ``(counts, errors)`` like
    ``validate_metrics_jsonl``."""
    errors: List[str] = []
    counts = {"findings": 0, "errors": 0, "warnings": 0, "infos": 0}
    try:
        with open(path) as f:
            rep = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return counts, [f"cannot read {path}: {e}"]
    if not isinstance(rep, dict):
        return counts, ["lint report is not a JSON object"]
    got = set(rep)
    if got != LINT_REPORT_KEYS:
        extra, missing = got - LINT_REPORT_KEYS, LINT_REPORT_KEYS - got
        if missing:
            errors.append(f"lint report missing keys: {sorted(missing)}")
        if extra:
            errors.append(f"lint report unexpected keys: {sorted(extra)}")
        return counts, errors
    if rep["version"] != 1:
        errors.append(f"unknown lint report version {rep['version']!r}")
    recount: Dict[str, int] = {}
    n_err = 0
    for i, f in enumerate(rep["findings"]):
        if not isinstance(f, dict) or set(f) != LINT_FINDING_KEYS:
            errors.append(f"finding {i}: wrong keys "
                          f"{sorted(f) if isinstance(f, dict) else f}")
            continue
        counts["findings"] += 1
        sev = f["severity"]
        if sev not in ("error", "warning", "info"):
            errors.append(f"finding {i}: unknown severity {sev!r}")
            continue
        counts[sev + "s"] += 1
        n_err += sev == "error"
        key = f"{f['check']}/{sev}"
        recount[key] = recount.get(key, 0) + 1
    if bool(rep["clean"]) != (n_err == 0):
        errors.append(
            f"clean={rep['clean']} but the report carries {n_err} "
            "error finding(s)")
    if rep["counters"] != recount:
        errors.append(
            f"counters {rep['counters']} disagree with a recount "
            f"{recount}")
    if not rep["passes"]:
        errors.append("no passes recorded")
    return counts, errors
