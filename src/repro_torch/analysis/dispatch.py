"""Pass 2: packed-dispatch lint, proving every planned leaf stays fused.

Port of ``repro.analysis.dispatch``. The packed-weight saving collapses
silently: a spec tweak in ``models/layers.py`` or a new call site can
drop a ``PackedTensor`` onto a materialized decode, and nothing fails:
the numbers are identical, only the weight-read bytes grow. The kernel
wrappers keep every distinct dispatch decision
(``kernels.ops.DISPATCH_RECORDS`` / ``FALLBACK_RECORDS``). This pass
runs the *real* entry points, ``decode_step`` (dense and paged states),
``prefill_step``, ``verify_step`` and the packed-master train body's
forward (``lm.loss(st_tree(packed, masters), batch)``), with the plan's
packed parameters, and turns the records of that window into findings:

* any **fallback** record is an error (with the recorded spec, shape,
  width and reason, plus the candidate plan leaves whose shape and
  width match). On the card a packed operand off the fused path is
  refused (``models.layers.FusedPathRefused``) instead of recorded: the
  window records the refusal as the fallback it stands for, so the card
  gives the same error the CPU does;
* any materialized ``unpack`` record (``kernels.ops.unpack``, B7 on the
  card) of rank >= 2 whose (shape, bits) matches a planned leaf is an
  error: a planned weight was decoded wholesale instead of streamed
  through a kernel (rank-1 records are benign vectors). As in the
  reference, the models' ``unpack_maybe`` records are not read: a
  packed weight that reaches it off a kernel path leaves a fallback
  record (above), and the rest is the by-design decode, once per
  parameter tree, of ``blocks.PLAIN_LEAVES`` (norm scales, the
  depthwise conv, the recurrent diagonals);
* every planned leaf must have a positive **fused** proof: a
  ``packed_matmul`` / ``packed_matmul_batched`` / ``take_rows`` record
  matching its payload or logical shape (stacked leaves match with the
  leading layer axis stripped, since the model slices them). Matching is
  at shape-class granularity: the call site does not know leaf paths,
  so two same-shape same-width leaves are proven by either's record;
* the paged decode must land on the **fused paged-attention** kernel:
  any ``gather_kv_pages`` record in the window, or a missing
  ``fused_paged`` dispatch, is an error.

The port runs the entry points eagerly on the caller's device, so on
the card the window launches the kernels. The reference records once
per traced program; the port keeps each distinct record once, so a
record seen before the window (an earlier run in the same process)
would never reappear inside it. The window therefore sets the record
sets aside and clears them, reads what the entry points record, and
then restores the union.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.report import Finding
from repro_torch.core.calibrate import _extra_inputs, _leaves_sorted
from repro_torch.core.compress import path_str, repacked_copy, uniform_plan
from repro_torch.core.tensor_store import PackedTensor, is_packed, st_tree
from repro_torch.kernels import ops as kops
from repro_torch.models.layers import FusedPathRefused

_FUSED_OPS = ("packed_matmul", "packed_matmul_batched", "take_rows")


def _packed_leaves(tree: Any) -> Dict[str, PackedTensor]:
    return {path_str(path): leaf for path, leaf in _leaves_sorted(tree)
            if is_packed(leaf)}


def _shape_classes(pk: PackedTensor) -> Tuple[Tuple[int, ...], ...]:
    """The shapes under which this leaf's dispatch records can appear:
    payload words / logical, whole or with the stacked layer axis
    stripped (the model slices stacked leaves per layer)."""
    data = tuple(pk.data.shape)
    logical = tuple(pk.logical_shape)
    out = [data, logical]
    if len(data) >= 3:
        out.append(data[1:])
    if len(logical) >= 3:
        out.append(logical[1:])
    return tuple(out)


def _train_batch(cfg, batch_size: int, seq_len: int,
                 device) -> Dict[str, torch.Tensor]:
    batch = {
        "tokens": torch.zeros((batch_size, seq_len), dtype=torch.int32),
        "labels": torch.zeros((batch_size, seq_len), dtype=torch.int32),
    }
    batch.update(_extra_inputs(cfg, batch_size))
    return {k: v.to(device) for k, v in batch.items()}


def record_refusal(e: FusedPathRefused) -> None:
    """The card's refusal of an unfused packed operand, kept as the
    fallback record the CPU keeps for it."""
    kops.record_fallback(e.op, spec=e.spec, shape=e.shape, bits=e.bits,
                         reason=e.reason)


def trace_entry_points(cfg, packed, masters, batch_size: int = 1,
                       seq_len: int = 32, device=None,
                       ) -> Tuple[List[str], List[Finding]]:
    """Run each real entry point with the packed parameters on
    ``device``; returns the entry points that ran to their end plus
    findings for any that did not. On the card this launches the
    kernels; each entry point starts from a fresh decode state."""
    from repro_torch.models.lm import LM
    lm = LM(cfg, device=device)
    dev = lm.device
    b = batch_size
    tokens1 = torch.zeros((b, 1), dtype=torch.int32, device=dev)
    tokens4 = torch.zeros((b, 4), dtype=torch.int32, device=dev)
    n_valid = torch.full((b,), 4, dtype=torch.int32, device=dev)

    def state():
        return lm.init_decode_state(b, seq_len)

    entry_points = [
        ("decode_step", lambda: lm.decode_step(packed, state(), tokens1)),
        ("prefill_step",
         lambda: lm.prefill_step(packed, state(), tokens4, n_valid)),
        ("verify_step", lambda: lm.verify_step(packed, state(), tokens4)),
        ("train_loss",
         lambda: lm.loss(st_tree(packed, masters),
                         _train_batch(cfg, b, seq_len, dev))),
    ]
    if lm.supports_rollback:
        # the paged serving hot path: decode_step over a page-pool state
        # must dispatch onto the fused paged-attention kernel, never the
        # gather route; lint_dispatch checks the records it leaves
        def _paged():
            pstate = lm.init_paged_decode_state(
                b, seq_len, page_size=8, n_pages=max(b * 4, 2))
            return lm.decode_step(packed, pstate, tokens1)
        entry_points.insert(1, ("paged_decode_step", _paged))
    traced: List[str] = []
    notes: List[Finding] = []
    for name, thunk in entry_points:
        try:
            with torch.no_grad():
                thunk()
            traced.append(name)
        except FusedPathRefused as e:
            # the card refused a packed operand: the fallback record is
            # the error; the entry point did not run to its end
            record_refusal(e)
        except NotImplementedError as e:
            notes.append(Finding(
                check="dispatch", severity="info", path=name,
                message=f"entry point {name} unsupported for family "
                        f"{cfg.family!r}: {e}"))
        except Exception as e:                 # noqa: BLE001: the lint
            # keeps auditing the other entry points; the failure itself
            # is a (non-gating) warning with the error attached
            notes.append(Finding(
                check="dispatch", severity="warning", path=name,
                message=f"tracing {name} failed: {type(e).__name__}: {e}"))
    return traced, notes


def _window(run) -> Tuple[Any, List[kops.DispatchRecord],
                          List[kops.DispatchRecord]]:
    """``run()`` with the record sets cleared: its result and the
    dispatch and fallback records it left. The records from before are
    restored, with the window's added."""
    saved = (dict(kops.DISPATCH_RECORDS), dict(kops.FALLBACK_RECORDS))
    kops.DISPATCH_RECORDS.clear()
    kops.FALLBACK_RECORDS.clear()
    try:
        out = run()
        new = (list(kops.DISPATCH_RECORDS), list(kops.FALLBACK_RECORDS))
    finally:
        for live, before in zip((kops.DISPATCH_RECORDS,
                                 kops.FALLBACK_RECORDS), saved):
            union = dict(before)
            union.update(live)
            live.clear()
            live.update(union)
    return out, new[0], new[1]


def lint_dispatch(cfg, plan=None, params: Optional[Dict] = None,
                  batch_size: int = 1, seq_len: int = 32,
                  extra_trace=None, device=None,
                  ) -> Tuple[List[Finding], List[str]]:
    """Run the dispatch lint; returns ``(findings, entry points run)``.

    ``extra_trace`` (a thunk) runs inside the record window before the
    entry points: the hook the negative leg uses to seed a known-bad
    dispatch that the lint must then catch (on the card, its refusal is
    recorded like any other)."""
    findings: List[Finding] = []
    if params is None:
        from repro_torch.models.lm import LM
        params = LM(cfg, device=device).init()
    if plan is None or not plan.float_bits:
        plan = uniform_plan(params, cfg.resolved_weight_bits)
    packed = repacked_copy(params, plan)
    leaves = _packed_leaves(packed)

    def run():
        if extra_trace is not None:
            try:
                extra_trace()
            except FusedPathRefused as e:
                record_refusal(e)
        return trace_entry_points(cfg, packed, params, batch_size, seq_len,
                                  device)

    (traced, notes), new_dispatch, new_fallback = _window(run)
    findings.extend(notes)

    def candidates(rec) -> List[str]:
        return [p for p, pk in leaves.items()
                if pk.bits == rec.bits
                and tuple(rec.shape) in _shape_classes(pk)]

    # -- fallbacks: always errors -------------------------------------------
    for rec in new_fallback:
        cands = candidates(rec)
        findings.append(Finding(
            check="dispatch", severity="error", path=";".join(cands),
            message=(
                f"packed operand fell off the fused path in {rec.op} "
                f"(reason={rec.reason or 'unknown'}, spec={rec.spec!r}, "
                f"shape={tuple(rec.shape)}, bits={rec.bits}); candidate "
                f"leaves: {cands or '<no planned leaf matches>'}"),
            detail={"op": rec.op, "spec": rec.spec,
                    "shape": list(rec.shape), "bits": rec.bits,
                    "reason": rec.reason, "candidates": cands},
        ))

    # -- the paged decode hot path must stay fused --------------------------
    if "paged_decode_step" in traced:
        for rec in new_dispatch:
            if rec.op != "gather_kv_pages":
                continue
            findings.append(Finding(
                check="dispatch", severity="error", path="paged_decode_step",
                message=(
                    f"paged decode dispatched onto gather_kv_pages "
                    f"(materialized page view, pool shape "
                    f"{tuple(rec.shape)}) instead of the fused "
                    f"paged-attention kernel"),
                detail={"op": rec.op, "shape": list(rec.shape)},
            ))
        if not any(r.op == "paged_attention" and r.path == "fused_paged"
                   for r in new_dispatch):
            findings.append(Finding(
                check="dispatch", severity="error",
                path="paged_decode_step",
                message=(
                    "paged decode ran without a fused_paged "
                    "paged_attention dispatch: the paged hot path "
                    "silently de-fused"),
                detail={"traced": traced},
            ))

    # -- wholesale decode of a planned leaf ---------------------------------
    for rec in new_dispatch:
        if rec.op != "unpack" or len(rec.shape) < 2:
            continue
        cands = candidates(rec)
        if cands:
            findings.append(Finding(
                check="dispatch", severity="error", path=";".join(cands),
                message=(
                    f"planned leaf decoded wholesale (materialized unpack, "
                    f"shape={tuple(rec.shape)}, bits={rec.bits}) instead "
                    f"of a fused kernel; candidate leaves: {cands}"),
                detail={"shape": list(rec.shape), "bits": rec.bits,
                        "candidates": cands},
            ))

    # -- positive fused proof per planned leaf ------------------------------
    # Exempt vector-class leaves: a stacked (L, d) norm scale under a
    # ``*blocks/`` stack is consumed as rank-1 slices, with no matmul to
    # fuse. Every weight matrix under a stack is rank 3 (stacked on L);
    # top-level rank-2 leaves (embed, lm_head) still need their proof.
    fused = [(r, tuple(r.shape)) for r in new_dispatch
             if r.op in _FUSED_OPS]
    for path, pk in sorted(leaves.items()):
        if (path.split("/", 1)[0].endswith("blocks")
                and len(pk.logical_shape) == 2):
            continue
        classes = _shape_classes(pk)
        if not any(r.bits == pk.bits and shp in classes
                   for r, shp in fused):
            findings.append(Finding(
                check="dispatch", severity="error", path=path,
                message=(
                    f"no fused-kernel dispatch proves planned leaf {path} "
                    f"(logical shape {tuple(pk.logical_shape)}, "
                    f"AF{pk.bits}) across "
                    f"{'/'.join(traced) or 'no entry points'}"),
                detail={"logical_shape": list(pk.logical_shape),
                        "bits": pk.bits, "traced": traced},
            ))
    if all(f.severity == "info" for f in findings):
        findings.append(Finding(
            check="dispatch", severity="info",
            message=(
                f"all {len(leaves)} planned leaves proven fused across "
                f"{'/'.join(traced)} "
                f"({len(fused)} distinct fused dispatch records)"),
            detail={"traced": traced},
        ))
    return findings, traced
