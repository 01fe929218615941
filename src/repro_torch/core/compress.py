"""The static compression flow (Fig. 7), at both granularities.

Port of ``repro.core.compress``.

**Kernel granularity** (the paper's evaluation pipeline):
``compress_kernel`` exports a kernel (``QuantizedKernel``), bounds its
integer values (``RangeAnalysis``, Section 4.2, with the caller's input
ranges), tunes the width of every float value against a quality
threshold (``tune_kernel``, Section 4.1), computes each value's live
range over the graph and packs the values into register slices with
indirection tables (``SliceAllocator``, Section 4.3). The result,
``KernelCompression``, holds the register pressure before and after,
which the occupancy and SM models turn into the paper's Fig. 9-11.

**Tensor granularity** (the framework's deployment path): the
``CompressionPlan`` (per-leaf widths, versioned JSON codec, footprint
and mean-width accounting), ``plan_tensors`` (a plan from the
quality-gated tensor tuning and integer ranges), ``uniform_plan`` (one
Table 3 width for every float leaf of rank >= 2), ``derive_plan`` (the
speculative draft's plan, one step down the ladder), ``repack``
(re-encode a parameter tree at a plan's widths, in place) and
``repacked_copy`` (the same into fresh containers, leaving the source
tree as it was). A whole model's plan comes from ``core.calibrate``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.allocator import Allocation, Operand, SliceAllocator
from repro_torch.core.formats import ladder_snap, round_bits_to_slice
from repro_torch.core.precision_tuning import (QuantizedKernel, tune_kernel,
                                               tune_tensors)
from repro_torch.core.quality import QualitySpec
from repro_torch.core.range_analysis import TOP, Interval, RangeAnalysis
from repro_torch.core.tensor_store import (Draw, is_draw, is_packed,
                                           pack_tensor, repack_tensor,
                                           tree_map_with_path)


# ---------------------------------------------------------------------------
# Kernel granularity: per-SSA-value compression of an exported kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KernelCompression:
    """Everything Fig. 7 produces for one kernel."""

    name: str
    allocation: Allocation           # packed
    baseline_pressure: int           # 32-bit registers, liveness-aware
    packed_pressure: int
    float_formats: Dict[int, int]    # vid -> bits
    int_bits: Dict[str, Tuple[int, bool]]
    tune_evals: int
    operands: List[Operand] = dataclasses.field(default_factory=list)

    def repressure(self, use_ints: bool, use_floats: bool,
                   prefer_contiguous: bool = False) -> int:
        """Register pressure with only one side of the framework active
        (Fig. 9's isolated bars), liveness preserved."""
        ops = [
            dataclasses.replace(
                o,
                bits=o.bits if (o.is_float and use_floats)
                or ((not o.is_float) and use_ints) else 32,
            )
            for o in self.operands
        ]
        return SliceAllocator(
            prefer_contiguous=prefer_contiguous
        ).allocate(ops).register_pressure

    @property
    def pressure_reduction(self) -> float:
        return 1.0 - self.packed_pressure / max(self.baseline_pressure, 1)


def _placeholders(kernel: QuantizedKernel
                  ) -> Tuple[List[torch.fx.Node], List[torch.fx.Node]]:
    """The graph's user inputs and its lifted constants, each in order
    (the reference's invars and constvars)."""
    from torch.export.graph_signature import InputKind

    placeholders = [n for n in kernel.graph.nodes if n.op == "placeholder"]
    pairs = list(zip(placeholders, kernel.input_kinds))
    return ([n for n, k in pairs if k == InputKind.USER_INPUT],
            [n for n, k in pairs if k != InputKind.USER_INPUT])


def _liveness(kernel: QuantizedKernel) -> Dict[torch.fx.Node, Tuple[int, int]]:
    """[def_point, last_use) of every value: the inputs and the lifted
    constants at (0, 1), the t-th ``call_function`` node (from 1) at
    (t, t + 1), each extended to one past its last use; the outputs live
    to the end."""
    user, lifted = _placeholders(kernel)
    live: Dict[torch.fx.Node, Tuple[int, int]] = {
        n: (0, 1) for n in user + lifted}
    calls = [n for n in kernel.graph.nodes if n.op == "call_function"]
    for t, node in enumerate(calls, start=1):
        live[node] = (t, t + 1)
        for a in node.all_input_nodes:
            if a in live:
                live[a] = (live[a][0], t + 1)
    end = len(calls) + 1
    for node in kernel.graph.nodes:
        if node.op == "output":
            for a in node.all_input_nodes:
                if a in live:
                    live[a] = (live[a][0], end)
    return live


def compress_kernel(
    name: str,
    fn: Callable,
    samples: Sequence[Tuple],
    quality: QualitySpec,
    input_ranges: Optional[Sequence[Optional[Interval]]] = None,
    prefer_contiguous: bool = False,
    device: Optional[Union[str, torch.device]] = None,
) -> KernelCompression:
    """Run the whole static framework on one kernel, on ``device`` (the
    card unless the caller names the CPU)."""
    qk = QuantizedKernel(fn, *samples[0], device=device)
    samples = [qk.to_device(s) for s in samples]

    # 1. integer ranges (Section 4.2)
    ra = RangeAnalysis(qk.program.graph_module)
    ranges = list(input_ranges or [])
    user, lifted = _placeholders(qk)
    for i, node in enumerate(user):
        ra._write(node, ranges[i] if i < len(ranges) and ranges[i] else TOP)
    for node in lifted:
        ra._write(node, TOP)
    for node in qk.graph.nodes:
        if node.op not in ("placeholder", "output"):
            ra._transfer(node)

    # 2. float precision tuning (Section 4.1)
    tuned = tune_kernel(qk, samples, quality)

    # 3. liveness and operands
    operands: List[Operand] = []
    int_bits: Dict[str, Tuple[int, bool]] = {}
    idx = 0
    for node, (start, end) in _liveness(qk).items():
        val = node.meta.get("val")
        if not isinstance(val, torch.Tensor):
            continue
        oname = f"v{idx}"
        idx += 1
        if val.is_floating_point():
            bits = tuned.formats.get(qk.vid_of.get(node, -1), 32)
            operands.append(Operand(name=oname, bits=bits, is_float=True,
                                    signed=True, start=start, end=end))
        elif not val.is_complex():           # integers and booleans
            itv = ra.env.get(node, TOP)
            b = itv.bits() if isinstance(itv, Interval) else None
            bits, signed = b if b else (32, True)
            bits = min(bits, 32)
            int_bits[oname] = (bits, signed)
            operands.append(Operand(name=oname, bits=bits, is_float=False,
                                    signed=signed, start=start, end=end))

    # 4. slice allocation (Section 4.3)
    alloc = SliceAllocator(prefer_contiguous=prefer_contiguous).allocate(
        operands)
    return KernelCompression(
        name=name,
        allocation=alloc,
        baseline_pressure=alloc.baseline_pressure,
        packed_pressure=alloc.register_pressure,
        float_formats=dict(tuned.formats),
        int_bits=int_bits,
        tune_evals=tuned.evaluations,
        operands=operands,
    )


# ---------------------------------------------------------------------------
# Tensor granularity: the framework deployment plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CompressionPlan:
    """Per-tensor widths consumed by the packed store.

    ``float_bits``: leaf-path string -> Table 3 width.
    ``int_bits``:   leaf-path string -> (bits, signed).
    ``kv_bits``:    ``"kv/layer_{i}"`` -> KV-cache width for that layer.
    """

    float_bits: Dict[str, int]
    int_bits: Dict[str, Tuple[int, bool]]
    tune_evals: int = 0
    kv_bits: Dict[str, int] = dataclasses.field(default_factory=dict)

    def bits_of(self, path: Tuple[Any, ...], leaf):
        """A bare width for floats, ``(width, signed)`` for ints, or
        ``None`` to leave the leaf unpacked."""
        key = path_str(path)
        if key in self.float_bits:
            return self.float_bits[key]
        if key in self.int_bits:
            bits, signed = self.int_bits[key]
            return round_bits_to_slice(bits), signed
        return None

    def footprint_ratio(self, tensors: Dict[str, torch.Tensor]) -> float:
        """Packed bytes / f32 bytes over the planned tensors."""
        num = den = 0.0
        for k, v in tensors.items():
            n = float(max(v.numel(), 1))
            if k in self.float_bits:
                bits = self.float_bits[k]
            elif k in self.int_bits:
                bits = round_bits_to_slice(self.int_bits[k][0])
            else:
                bits = 32
            num += n * bits
            den += n * 32
        return num / max(den, 1.0)

    def mean_float_bits(self, sizes: Optional[Dict[str, int]] = None
                        ) -> float:
        """Mean width over the float leaves: weighted by element count
        when ``sizes`` are given (one large embedding at AF8 outweighs a
        dozen small leaves at AF24), a plain mean otherwise; 32.0 for an
        empty plan."""
        if not self.float_bits:
            return 32.0
        if sizes:
            num = sum(b * sizes.get(k, 1) for k, b in self.float_bits.items())
            den = sum(sizes.get(k, 1) for k in self.float_bits)
            return num / max(den, 1)
        return sum(self.float_bits.values()) / len(self.float_bits)

    def kv_layer_widths(self, n_layers: int, default: int) -> Tuple[int, ...]:
        """Per-layer KV widths: ``kv_bits["kv/layer_i"]`` where the plan
        names the layer, ``default`` elsewhere."""
        return tuple(int(self.kv_bits.get(f"kv/layer_{i}", default))
                     for i in range(n_layers))

    # -- JSON codec (schema v1, the reference's file format) --------------
    def to_jsonable(self) -> Dict[str, Any]:
        return {
            "version": 1,
            "float_bits": {k: int(v) for k, v in
                           sorted(self.float_bits.items())},
            "int_bits": {k: [int(b), bool(s)] for k, (b, s) in
                         sorted(self.int_bits.items())},
            "tune_evals": int(self.tune_evals),
            "kv_bits": {k: int(v) for k, v in sorted(self.kv_bits.items())},
        }

    @classmethod
    def from_jsonable(cls, obj: Dict[str, Any]) -> "CompressionPlan":
        version = obj.get("version", 1)
        if version != 1:
            raise ValueError(f"unknown CompressionPlan schema v{version}")
        return cls(
            float_bits={k: int(v) for k, v in
                        obj.get("float_bits", {}).items()},
            int_bits={k: (int(v[0]), bool(v[1])) for k, v in
                      obj.get("int_bits", {}).items()},
            tune_evals=int(obj.get("tune_evals", 0)),
            kv_bits={k: int(v) for k, v in obj.get("kv_bits", {}).items()},
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_jsonable(), f, indent=2, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path: str) -> "CompressionPlan":
        with open(path) as f:
            return cls.from_jsonable(json.load(f))


def path_str(path: Tuple[Any, ...]) -> str:
    return "/".join(str(p) for p in path)


def plan_tensors(
    apply_fn: Callable[[Dict[str, torch.Tensor]], Any],
    tensors: Dict[str, torch.Tensor],
    quality: QualitySpec,
    int_ranges: Optional[Dict[str, Interval]] = None,
) -> CompressionPlan:
    """A tensor-level plan: float tensors tuned (``tune_tensors``),
    integer tensors at the widths of ``int_ranges`` (else of their
    values' range)."""
    tuned = tune_tensors(apply_fn, tensors, quality)
    int_bits: Dict[str, Tuple[int, bool]] = {}
    for k, v in tensors.items():
        if v.is_floating_point() or v.is_complex() or v.dtype == torch.bool:
            continue
        itv = (int_ranges or {}).get(k)
        if itv is None:
            itv = Interval(float(v.min()), float(v.max()))
        b = itv.bits()
        if b:
            int_bits[k] = b
    return CompressionPlan(
        float_bits={k: b for k, b in tuned.formats.items() if b < 32},
        int_bits=int_bits,
        tune_evals=tuned.evaluations,
    )


def uniform_plan(tree: Any, bits: int, min_ndim: int = 2) -> CompressionPlan:
    """One Table 3 width for every float leaf with ``ndim >= min_ndim``
    (matmul weights, embedding tables and the layer-stacked (L, d) norm
    scales, which decode on the materialized path); 1-D leaves stay at
    the compute dtype."""
    float_bits: Dict[str, int] = {}
    if bits is None or bits >= 32:
        return CompressionPlan(float_bits={}, int_bits={})

    def visit(path, leaf):
        if is_packed(leaf):
            if leaf.kind == "float":
                float_bits[path_str(path)] = bits
        elif (isinstance(leaf, (torch.Tensor, Draw))
              and leaf.is_floating_point() and leaf.ndim >= min_ndim):
            float_bits[path_str(path)] = bits
        return leaf

    tree_map_with_path(visit, tree)
    return CompressionPlan(float_bits=float_bits, int_bits={})


def derive_plan(plan: CompressionPlan, delta_bits: int = 4) -> CompressionPlan:
    """The draft's plan: every float leaf ``delta_bits`` down the Table 3
    ladder (the widest rung at or below, floored at AF8), every
    ``kv_bits`` entry one rung down, integer widths carried over (they
    are exact). Fresh dicts, never the source plan's."""
    if delta_bits < 0:
        raise ValueError(f"delta_bits must be >= 0, got {delta_bits}")
    return CompressionPlan(
        float_bits={key: ladder_snap(bits - delta_bits)
                    for key, bits in plan.float_bits.items()},
        int_bits=dict(plan.int_bits),
        tune_evals=plan.tune_evals,
        kv_bits={key: ladder_snap(bits, below=True)
                 for key, bits in plan.kv_bits.items()})


def repack(tree: Any, plan: CompressionPlan) -> Any:
    """Re-encode a (partially packed) tree at ``plan``'s widths, leaf by
    leaf and in place: each leaf of a dict or list is replaced as soon as
    its packed version exists, so the peak is one tree plus one leaf in
    flight, not two trees (full deepseek-moe-16b holds 34 GB of bf16
    weights and as much packed). A tuple comes back rebuilt. A packed
    leaf re-encodes value by value (the same object at an unchanged
    width), a plain leaf the plan names is packed, the rest pass
    through. A ``Draw`` leaf is drawn here: one the plan packs, a slice
    at a time straight into its packed words (``Draw.draw_packed``: the
    peak is the packed tree plus one slice), any other whole. Returns
    the tree."""

    def visit(node, path):
        if isinstance(node, (dict, list)):
            for key in (list(node) if isinstance(node, dict)
                        else range(len(node))):
                node[key] = visit(node[key], path + (key,))
            return node
        if isinstance(node, tuple):
            return type(node)(visit(v, path + (i,))
                              for i, v in enumerate(node))
        spec = plan.bits_of(path, node)
        bits, signed = spec if isinstance(spec, tuple) else (spec, True)
        if is_draw(node):
            return (node.draw_packed(bits) if bits is not None and bits < 32
                    else node.draw())
        if spec is None:
            return node
        if is_packed(node):
            return repack_tensor(node, bits)
        if bits is None or bits >= 32:
            return node
        return pack_tensor(node, bits, signed=signed)

    return visit(tree, ())


def repacked_copy(tree: Any, plan: CompressionPlan) -> Any:
    """``repack`` into a fresh copy of the tree's containers: the source
    tree keeps every leaf it had, and the two trees share only the
    leaves the plan leaves as they are (as the reference's ``repack``,
    which returns a new tree)."""
    return repack(tree_map_with_path(lambda _, leaf: leaf, tree), plan)
