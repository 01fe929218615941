"""Whole-program static analysis: the paper's compiler flow (Section 4)
as a correctness gate. Port of ``repro.analysis``.

Five passes over the real entry points (``LM.decode_step`` /
``prefill_step`` / ``verify_step``, the packed-master train body):

1. **activation range inference** (``activations``): float magnitude
   bounds through the K/V projection -> per-layer KV-cache widths,
   emitted as ``CompressionPlan.kv_bits`` entries;
2. **plan soundness** (``soundness``): plan int widths against the
   range-analysis proofs (silent clipping), float widths against the
   Table 3 ladder and the leaves' magnitudes;
3. **packed dispatch** (``dispatch``): every planned float leaf must hit
   a fused kernel; on the card the entry points run the kernels;
4. **sharding and donation** (``sharding_lint``): the group-of-32
   packed-axis rule, and reads of the decode state after an overwrite
   in ``decode_step``'s functional graph.

CLI: ``python -m repro_torch.analysis.lint --arch X [--plan plan.json]
[--out report.json] [--device cpu]``; nonzero exit on error findings.
"""
from repro_torch.analysis.activations import (
    FloatRangeAnalysis,
    infer_kv_widths,
    width_for_bound,
)
from repro_torch.analysis.dispatch import lint_dispatch
from repro_torch.analysis.report import Finding, LintReport
from repro_torch.analysis.sharding_lint import lint_donation, lint_sharding
from repro_torch.analysis.soundness import lint_plan

__all__ = [
    "Finding",
    "FloatRangeAnalysis",
    "LintReport",
    "infer_kv_widths",
    "lint_dispatch",
    "lint_donation",
    "lint_plan",
    "lint_sharding",
    "width_for_bound",
]
