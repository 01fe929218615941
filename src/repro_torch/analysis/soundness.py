"""Pass 3: plan-soundness verifier, widths against what the analysis proves.

Port of ``repro.analysis.soundness``. A ``CompressionPlan`` is an
*assertion* about value ranges; nothing in the packed store checks it.
An integer entry narrower than the stream's proven range **silently
clips** (the encoder masks high bits: token id 300 stored at 4 bits
decodes as 12, no error anywhere); a float entry whose format
``max_finite`` is below the leaf's actual magnitude saturates the same
way; an off-ladder float width has no Table 3 decode network at all.
This pass re-derives the proofs (``core.calibrate.derive_int_bits``'s
interval analysis for the input streams, the leaves' max magnitudes,
read with torch on their device, for float leaves, the pass-1
activation bounds for KV entries) and reports every plan entry the
proofs do not cover:

* int entry narrower than the proven width, or signed/unsigned mismatch
  against the proven signedness -> **error**;
* float entry off the Table 3 ladder -> **error**; float entry whose
  ``max_finite`` is below the leaf's max |value| -> **error**;
* ``kv/layer_i`` entry with ``i`` outside the config's KV layers, off
  the ladder, or narrower than the pass-1 proven activation bound ->
  **error**;
* plan keys naming streams or leaves that do not exist -> **warning**
  (stale plans lint loudly but do not gate).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.analysis.report import Finding
from repro_torch.core.calibrate import derive_int_bits, float_leaves
from repro_torch.core.formats import FLOAT_FORMATS


def _abs_max(leaf: torch.Tensor) -> float:
    return float(leaf.detach().abs().max()) if leaf.numel() else 0.0


def lint_plan(cfg, plan, params: Optional[Dict] = None,
              max_seq_len: int = 4096,
              kv_bounds: Optional[Dict[str, float]] = None,
              ) -> List[Finding]:
    findings: List[Finding] = []

    # -- integer streams against the interval-analysis proofs ---------------
    proven = derive_int_bits(cfg, max_seq_len)
    for key, (bits, signed) in sorted(plan.int_bits.items()):
        if key not in proven:
            findings.append(Finding(
                check="plan_soundness", severity="warning", path=key,
                message=(
                    f"int entry {key} names no proven input stream of "
                    f"this config (stale plan?)"),
            ))
            continue
        p_bits, p_signed = proven[key]
        if bits < p_bits:
            findings.append(Finding(
                check="plan_soundness", severity="error", path=key,
                message=(
                    f"silent clipping: {key} planned at {bits} bits but "
                    f"the range analysis proves the stream needs "
                    f"{p_bits}: a representable input wraps modulo "
                    f"2^{bits} with no runtime error"),
                detail={"plan_bits": bits, "proven_bits": p_bits},
            ))
        if signed != p_signed:
            findings.append(Finding(
                check="plan_soundness", severity="error", path=key,
                message=(
                    f"signedness mismatch: {key} planned "
                    f"{'signed' if signed else 'unsigned'} but proven "
                    f"{'signed' if p_signed else 'unsigned'}: decode "
                    f"{'drops the sign' if p_signed else 'sign-extends'}"
                    " values near the top of the range"),
                detail={"plan_signed": signed, "proven_signed": p_signed},
            ))

    # -- float leaves against the ladder and the leaves' magnitudes --------
    leaves = float_leaves(params, min_ndim=1) if params is not None else {}
    for key, bits in sorted(plan.float_bits.items()):
        if bits not in FLOAT_FORMATS:
            findings.append(Finding(
                check="plan_soundness", severity="error", path=key,
                message=(
                    f"float entry {key} planned at {bits} bits: not a "
                    f"Table 3 ladder width {sorted(FLOAT_FORMATS)}; no "
                    "decode network exists for it"),
                detail={"plan_bits": bits},
            ))
            continue
        if params is not None and key not in leaves:
            findings.append(Finding(
                check="plan_soundness", severity="warning", path=key,
                message=f"float entry {key} names no param leaf "
                        "(stale plan?)"))
            continue
        if params is not None:
            mx = _abs_max(leaves[key])
            cap = FLOAT_FORMATS[bits].max_finite
            if mx > cap:
                findings.append(Finding(
                    check="plan_soundness", severity="error", path=key,
                    message=(
                        f"silent clipping: {key} holds |values| up to "
                        f"{mx:.4g} but AF{bits} saturates at {cap:.4g}"),
                    detail={"plan_bits": bits, "abs_max": mx,
                            "max_finite": cap},
                ))

    # -- KV entries against the config and the pass-1 activation bounds ----
    n_kv = cfg.n_kv_layers
    for key, bits in sorted(plan.kv_bits.items()):
        try:
            layer = int(key.rsplit("_", 1)[1])
            ok_key = key.startswith("kv/layer_")
        except (IndexError, ValueError):
            layer, ok_key = -1, False
        if not ok_key or layer < 0:
            findings.append(Finding(
                check="plan_soundness", severity="error", path=key,
                message=f"malformed KV entry key {key!r} "
                        "(want 'kv/layer_<i>')"))
            continue
        if layer >= n_kv:
            findings.append(Finding(
                check="plan_soundness", severity="error", path=key,
                message=(
                    f"KV entry {key} names layer {layer} but the config "
                    f"has {n_kv} KV layers"),
                detail={"layer": layer, "n_kv_layers": n_kv},
            ))
            continue
        if bits not in FLOAT_FORMATS:
            findings.append(Finding(
                check="plan_soundness", severity="error", path=key,
                message=(
                    f"KV entry {key} planned at {bits} bits: not a "
                    f"Table 3 ladder width {sorted(FLOAT_FORMATS)}"),
                detail={"plan_bits": bits},
            ))
            continue
        if kv_bounds and key in kv_bounds:
            cap = FLOAT_FORMATS[bits].max_finite
            if cap < kv_bounds[key]:
                findings.append(Finding(
                    check="plan_soundness", severity="error", path=key,
                    message=(
                        f"KV overflow: {key} planned at AF{bits} "
                        f"(max_finite {cap:.4g}) but the activation "
                        f"analysis proves magnitudes up to "
                        f"{kv_bounds[key]:.4g}"),
                    detail={"plan_bits": bits, "bound": kv_bounds[key],
                            "max_finite": cap},
                ))
    if all(f.severity == "info" for f in findings):
        findings.append(Finding(
            check="plan_soundness", severity="info",
            message=(
                f"plan sound: {len(plan.int_bits)} int / "
                f"{len(plan.float_bits)} float / {len(plan.kv_bits)} KV "
                "entries verified against the derived proofs"),
        ))
    return findings
