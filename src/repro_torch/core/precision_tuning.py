"""Floating-point precision tuning (Section 4.1; Angerd et al. 2017).

Port of ``repro.core.precision_tuning``. Two granularities, one search:

* **Instruction level** (the paper's granularity): ``QuantizedKernel``
  exports a kernel to an ATen graph (``torch.export``) and re-runs it
  through a ``torch.fx.Interpreter`` that round-trips the output of
  every float-valued node through its assigned Table 3 format, so each
  SSA value carries its own width, as the paper's PTX registers do.
  ``tune_kernel`` searches those widths.
* **Tensor level** (the framework's granularity): ``tune_tensors`` gives
  each parameter tensor a format before it enters the packed store.

The search, for each value (largest footprint first), finds the
narrowest ladder format that keeps the user's quality metric within
threshold on the sample inputs, holding the values already tuned at
their accepted formats, and iterates to a fixpoint. Quality is only
guaranteed for inputs like the samples; the paper says the same.

A round trip through a format is the Value Truncator then the Value
Converter: ``kernels.ops.truncate`` and ``ops.convert`` (B8), the CUDA
kernels on the card and their plain versions on the CPU, the same bits
as the reference's ``decode_float(encode_float(x))``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.formats import FLOAT_LADDER
from repro_torch.core.quality import QualitySpec
from repro_torch.core.range_analysis import _Traced
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


def quantize_dequantize(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Round-trip ``x`` through the ``bits``-wide Table 3 format, in f32
    (at 32 bits, the f32 value itself, no launch)."""
    if bits >= 32:
        return x.to(torch.float32)
    return ops.convert(ops.truncate(x, bits), bits)


# ---------------------------------------------------------------------------
# Instruction level: the quantizing graph interpreter
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ValueInfo:
    """One float SSA value of the exported kernel."""

    vid: int                        # index into the kernel's value list
    prim: str                       # the ATen op that produces it
    shape: Tuple[int, ...]
    size: int


def _is_float_node(node: torch.fx.Node) -> bool:
    val = node.meta.get("val")
    return isinstance(val, torch.Tensor) and val.is_floating_point()


class _Quantizing(torch.fx.Interpreter):
    """Runs the graph, passing each numbered value through its width."""

    def __init__(self, kernel: "QuantizedKernel", formats: Dict[int, int]):
        super().__init__(kernel.program.graph_module)
        self.vid_of = kernel.vid_of
        self.formats = formats

    def run_node(self, n: torch.fx.Node) -> Any:
        out = super().run_node(n)
        vid = self.vid_of.get(n)
        if vid is not None:
            bits = self.formats.get(vid, 32)
            if bits < 32:
                out = quantize_dequantize(out, bits)
        return out


class QuantizedKernel:
    """An exported kernel whose float SSA values can be re-run at assigned
    widths. ``formats``: dict vid -> total bits (a value absent runs at
    32, unchanged).

    The kernel is exported on ``device`` (the card unless the caller
    names the CPU) with the example arguments moved there: tensors the
    kernel creates (an ``arange``) are recorded on the device of the
    export. Every ``call_function`` node with a float tensor value is
    numbered, in graph order, as a vid. ``run`` moves its arguments to
    the same device; on the card each round trip launches B8's
    ``truncate`` and ``convert``, and a dtype they refuse raises.
    """

    def __init__(self, fn: Callable, *example_args,
                 device: Optional[Union[str, torch.device]] = None):
        from torch.export import export
        from torch.export.graph_signature import InputKind

        self.device = resolve_device(device)
        args = self.to_device(example_args)
        self.program = export(_Traced(fn), args, strict=False)
        sig = self.program.graph_signature
        self.input_kinds = [spec.kind for spec in sig.input_specs]
        self._lifted = [
            None if spec.kind == InputKind.USER_INPUT
            else (self.program.constants[spec.target]
                  if spec.kind == InputKind.CONSTANT_TENSOR
                  else self.program.state_dict[spec.target])
            for spec in sig.input_specs]
        self.values: List[ValueInfo] = []
        self.vid_of: Dict[torch.fx.Node, int] = {}
        for node in self.program.graph_module.graph.nodes:
            if node.op == "call_function" and _is_float_node(node):
                val = node.meta["val"]
                vid = len(self.values)
                self.values.append(ValueInfo(
                    vid=vid,
                    prim=getattr(node.target, "_opname", str(node.target)),
                    shape=tuple(int(d) for d in val.shape),
                    size=math.prod(val.shape or (1,))))
                self.vid_of[node] = vid

    @property
    def graph(self) -> torch.fx.Graph:
        return self.program.graph_module.graph

    def to_device(self, args) -> tuple:
        return tuple(torch.as_tensor(a).to(self.device) for a in args)

    def run(self, formats: Dict[int, int], *args):
        """Evaluate with per-value quantization (32 bits: pass-through, no
        launch)."""
        user = iter(self.to_device(args))
        flat = [next(user) if lifted is None else lifted
                for lifted in self._lifted]
        with torch.no_grad():
            res = _Quantizing(self, formats).run(*flat)
        res = list(res) if isinstance(res, (list, tuple)) else [res]
        return res[0] if len(res) == 1 else tuple(res)


# ---------------------------------------------------------------------------
# The tuning search (shared by both granularities)
# ---------------------------------------------------------------------------

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


def tune_kernel(
    kernel: QuantizedKernel,
    samples: Sequence[Tuple],
    quality: QualitySpec,
    ladder: Sequence[int] = FLOAT_LADDER,
    reference: Optional[Sequence[Any]] = None,
) -> TuneResult:
    """Instruction-level tuning of an exported kernel (the paper's
    Fig. 7): every float value gets the narrowest ladder width that keeps
    each sample's outputs within ``quality`` of the unquantized run."""
    refs = reference or [kernel.run({}, *s) for s in samples]

    def acceptable(formats: Dict[int, int]) -> bool:
        for s, r in zip(samples, refs):
            out = kernel.run(formats, *s)
            outs = out if isinstance(out, tuple) else (out,)
            rs = r if isinstance(r, tuple) else (r,)
            for o, rr in zip(outs, rs):
                if not quality.accepts(rr, o):
                    return False
        return True

    keys = [v.vid for v in kernel.values]
    return _search(keys, lambda k: kernel.values[k].size, acceptable, ladder)


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
