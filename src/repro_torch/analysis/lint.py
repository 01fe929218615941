"""The lint gate: run the static passes over one architecture.

    python -m repro_torch.analysis.lint --arch qwen3_8b [--reduced] \
        [--plan plan.json] [--out report.json] [--max-seq-len N] \
        [--emit-kv-plan kv_plan.json] [--inject-fallback] [--device cpu]

Port of ``repro.analysis.lint``. The exit status is the contract: 0
when no pass raised an ``error`` finding, 1 otherwise; warnings and
info lines never gate. The report (``--out``) is the archived artifact
``python -m repro_torch.obs.validate --lint`` checks; counts are also
mirrored into the port's obs registry (``lint_findings_total``).
``--emit-kv-plan`` writes the versioned plan JSON with the inferred
per-layer ``kv_bits``, the interface between the two packages.

The gate runs on the CUDA device unless ``--device cpu`` (``device=
"cpu"``) asks for the plain versions: the parameters live there, the
leaves' magnitudes are read there and the dispatch pass runs the entry
points there, so on the card it proves that the kernels take every
packed operand. The donation pass traces on the CPU from shapes alone.

``--inject-fallback`` dispatches one packed leaf through an einsum spec
the fused path does not take before the entry points run: the seeded
negative leg, proving the dispatch pass fails when a packed operand
leaves the fused path (a lint that cannot fail proves nothing). On the
card that operand is refused, and the refusal is the error finding.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, Optional

from repro_torch.analysis.activations import infer_kv_widths
from repro_torch.analysis.dispatch import lint_dispatch
from repro_torch.analysis.report import LintReport
from repro_torch.analysis.sharding_lint import lint_donation, lint_sharding
from repro_torch.analysis.soundness import lint_plan
from repro_torch.core.calibrate import _leaves_sorted
from repro_torch.core.compress import CompressionPlan, uniform_plan
from repro_torch.core.formats import FLOAT_FORMATS
from repro_torch.core.tensor_store import pack_tensor


def run_lint(cfg, arch: str, plan=None, max_seq_len: int = 256,
             inject_fallback: bool = False, device=None,
             params: Optional[Dict] = None) -> LintReport:
    """All passes over one config; ``plan`` defaults to uniform at the
    config width (the serving default). ``params`` is the dense tree to
    lint, on ``device`` (default: ``LM(cfg).init()`` there, seed 0)."""
    from repro_torch.models.lm import LM

    report = LintReport(arch=arch)
    if params is None:
        params = LM(cfg, device=device).init()

    # pass 1: activation ranges -> per-layer KV widths
    kv_bits, kv_bounds, findings = infer_kv_widths(cfg, params=params)
    report.kv_bits, report.kv_bounds = kv_bits, kv_bounds
    report.extend(findings)
    report.passes.append("activation_width")

    # plan soundness runs before the passes that repack: the explicit
    # plan if given, else the uniform default plus the pass-1 KV entries
    checked = plan
    if checked is None:
        checked = uniform_plan(params, cfg.resolved_weight_bits)
        checked = dataclasses.replace(checked, kv_bits=dict(kv_bits))
    report.extend(lint_plan(cfg, checked, params=params,
                            max_seq_len=max_seq_len, kv_bounds=kv_bounds))
    report.passes.append("plan_soundness")

    # off-ladder entries have no decode network: drop them before the
    # passes repack (they are already errors above)
    safe_plan = plan
    if plan is not None:
        safe_plan = dataclasses.replace(plan, float_bits={
            k: v for k, v in plan.float_bits.items() if v in FLOAT_FORMATS})

    # pass 2: the packed-dispatch proof over the entry points (the
    # seeded fallback, if any, fires inside the record window)
    extra = ((lambda: _inject_fallback(cfg, params))
             if inject_fallback else None)
    findings, _ = lint_dispatch(cfg, plan=safe_plan, params=params,
                                extra_trace=extra, device=device)
    report.extend(findings)
    report.passes.append("dispatch")

    # pass 4: sharding + donation
    report.extend(lint_sharding(cfg, plan=safe_plan, params=params))
    report.passes.append("sharding")
    report.extend(lint_donation(cfg))
    report.passes.append("donation")

    report.mirror_to_obs()
    return report


def _inject_fallback(cfg, params) -> None:
    """Seeded failure: push one packed leaf (the first stacked weight,
    layer 0, at the config width) through an einsum spec the fused
    dispatcher does not recognize, inside the lint window."""
    import torch

    from repro_torch.models import layers as L

    w = next(leaf for _, leaf in _leaves_sorted(params)
             if leaf.is_floating_point() and leaf.ndim >= 3)
    w2 = pack_tensor(w[0], cfg.resolved_weight_bits)
    _, b = w2.logical_shape
    # "...b,ab->...a" is a valid einsum but contracts the weight's
    # *second* axis: not the plain matmul the fused kernel computes
    L.linear(torch.zeros((1, b), device=w.device), w2, spec="...b,ab->...a")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="lint the smoke-scale config (default; full "
                         "scale only changes sizes, not verdicts)")
    ap.add_argument("--plan", default=None, metavar="PLAN_JSON",
                    help="verify this calibrated plan instead of the "
                         "uniform default")
    ap.add_argument("--out", default=None, metavar="REPORT_JSON",
                    help="write the lint report artifact here")
    ap.add_argument("--max-seq-len", type=int, default=256,
                    help="deployment bound seeding the int-stream proofs")
    ap.add_argument("--emit-kv-plan", default=None, metavar="OUT_JSON",
                    help="also write a CompressionPlan JSON carrying the "
                         "statically inferred per-layer kv_bits")
    ap.add_argument("--inject-fallback", action="store_true",
                    help="seed an unfused dispatch before linting (the "
                         "negative leg: the lint must fail)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()

    plan = CompressionPlan.load(args.plan) if args.plan else None
    report = run_lint(cfg, args.arch, plan=plan,
                      max_seq_len=args.max_seq_len,
                      inject_fallback=args.inject_fallback,
                      device=args.device)

    if args.emit_kv_plan:
        kv_plan = plan or CompressionPlan(float_bits={}, int_bits={})
        kv_plan = dataclasses.replace(kv_plan, kv_bits=dict(report.kv_bits))
        kv_plan.save(args.emit_kv_plan)
    if args.out:
        report.save(args.out)

    for f in report.findings:
        stream = sys.stderr if f.severity == "error" else sys.stdout
        loc = f" [{f.path}]" if f.path else ""
        print(f"{f.severity.upper()} {f.check}{loc}: {f.message}",
              file=stream)
    n_err = len(report.errors)
    verdict = "clean" if report.clean else f"{n_err} error(s)"
    print(f"{args.arch}: lint {verdict} across "
          f"{'/'.join(report.passes)} ({len(report.findings)} findings)")
    return 0 if report.clean else 1


if __name__ == "__main__":
    raise SystemExit(main())
