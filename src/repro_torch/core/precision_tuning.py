"""Floating-point precision tuning at tensor granularity (Section 4.1;
Angerd et al. 2017).

Port of the tensor-level half of ``repro.core.precision_tuning``: the
parameter tensors are the value groups, and the search assigns each a
Table 3 format before it enters the packed store. For each tensor
(largest footprint first) it finds the narrowest ladder format that
keeps the user's quality metric within threshold on the sample inputs,
holding the tensors already tuned at their accepted formats, and
iterates to a fixpoint. Quality is only guaranteed for inputs like the
samples; the paper says the same.

A trial's round trip through a format is the Value Truncator then the
Value Converter: ``kernels.ops.truncate`` and ``ops.convert``, the CUDA
kernels on the card and their plain versions on the CPU, the same bits
as the reference's ``decode_float(encode_float(x))``.

The instruction-level half (``QuantizedKernel``, ``tune_kernel``: a
traced kernel re-run value by value at assigned widths) is not ported
yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.core.formats import FLOAT_LADDER
from repro_torch.core.quality import QualitySpec
from repro_torch.kernels import ops


def quantize_dequantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Round-trip ``x`` through the ``bits``-wide Table 3 format, in f32
    (at 32 bits, the f32 value itself, no launch)."""
    if bits >= 32:
        return x.to(torch.float32)
    return ops.convert(ops.truncate(x, bits), bits)


@dataclasses.dataclass
class TuneResult:
    formats: Dict[Any, int]          # value key -> accepted total bits
    evaluations: int                 # quality-metric evaluations performed

    def mean_bits(self, sizes: Optional[Dict[Any, int]] = None) -> float:
        if not self.formats:
            return 32.0
        if sizes:
            tot = sum(sizes[k] for k in self.formats)
            return sum(self.formats[k] * sizes[k] for k in self.formats) / tot
        return sum(self.formats.values()) / len(self.formats)


def _search(
    keys: Sequence[Any],
    weight: Callable[[Any], int],
    acceptable: Callable[[Dict[Any, int]], bool],
    ladder: Sequence[int] = FLOAT_LADDER,
    max_passes: int = 2,
) -> TuneResult:
    """Greedy largest-first descent with per-value ladder bisection."""
    formats: Dict[Any, int] = {k: 32 for k in keys}
    evals = 0
    rungs = sorted(ladder)           # narrowest first

    for _ in range(max_passes):
        changed = False
        for k in sorted(keys, key=weight, reverse=True):
            current = formats[k]
            # bisect the rungs below ``current`` for the narrowest
            # acceptable format (quality assumed monotone in bits, as the
            # heuristic of Angerd et al. does)
            cand = [b for b in rungs if b < current]
            lo, hi = 0, len(cand)            # answer in cand[lo:] or keep
            best = current
            while lo < hi:
                mid = (lo + hi) // 2
                trial = dict(formats)
                trial[k] = cand[mid]
                evals += 1
                if acceptable(trial):
                    best = cand[mid]
                    hi = mid
                else:
                    lo = mid + 1
            if best != current:
                formats[k] = best
                changed = True
        if not changed:
            break
    return TuneResult(formats=formats, evaluations=evals)


def tune_tensors(
    apply_fn: Callable[[Dict[str, torch.Tensor]], Any],
    tensors: Dict[str, torch.Tensor],
    quality: QualitySpec,
    ladder: Sequence[int] = FLOAT_LADDER,
    reference: Optional[Any] = None,
) -> TuneResult:
    """Assign each named tensor a Table 3 format.

    ``apply_fn`` maps the (quantized) tensor dict to the output the
    quality metric judges: for an LM, the losses on the sample batches.
    """
    ref = reference if reference is not None else apply_fn(tensors)
    float_keys = [k for k, v in tensors.items() if v.is_floating_point()]

    def acceptable(formats: Dict[str, int]) -> bool:
        q = {k: (quantize_dequantize(v, formats[k]) if k in formats else v)
             for k, v in tensors.items()}
        return quality.accepts(ref, apply_fn(q))

    return _search(float_keys, lambda k: max(tensors[k].numel(), 1),
                   acceptable, ladder)
