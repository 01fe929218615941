"""Static integer range analysis over exported ATen graphs (Section 4.2,
adapted).

Port of ``repro.core.range_analysis``. The paper runs Pereira et al.'s
range analysis on PTX in e-SSA form; the reference abstractly
interprets a jaxpr. Here ``torch.export.export`` traces the function to
an ATen graph, which is SSA by construction, and an interval domain is
propagated over every value of it. Leaf ranges come from
``input_specs`` metadata (token ids bounded by the vocabulary,
positions by the sequence length, expert ids by the expert count, ...).
Each jaxpr primitive the reference transfers maps to the ATen op(s)
that compute it; an op without a transfer gives ``Interval.top()``,
which keeps the analysis sound. The last step turns each value's
interval into a bitwidth exactly as Fig. 8d does.

Control flow: ``torch.ops.higher_order.while_loop`` and ``scan`` iterate
their body's transfer to a fixed point with widening, then narrow, as
the reference does for ``while``/``scan``; ``cond`` takes the union of
its branches.
"""
from __future__ import annotations

import dataclasses
import math
import operator
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.formats import int_bits_needed

INF = float("inf")
NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class Interval:
    """[lo, hi] over the integers; +-inf marks unbounded sides."""

    lo: float
    hi: float

    def __post_init__(self):
        if self.lo > self.hi:
            raise ValueError(f"empty interval [{self.lo}, {self.hi}]")

    @staticmethod
    def top() -> "Interval":
        return Interval(NEG_INF, INF)

    @staticmethod
    def const(v: float) -> "Interval":
        return Interval(v, v)

    @property
    def bounded(self) -> bool:
        return self.lo > NEG_INF and self.hi < INF

    def union(self, other: "Interval") -> "Interval":
        return Interval(min(self.lo, other.lo), max(self.hi, other.hi))

    def intersect(self, other: "Interval") -> Optional["Interval"]:
        lo, hi = max(self.lo, other.lo), min(self.hi, other.hi)
        return Interval(lo, hi) if lo <= hi else None

    def widen(self, other: "Interval") -> "Interval":
        """Standard interval widening: jump straight to +-inf on growth."""
        lo = self.lo if other.lo >= self.lo else NEG_INF
        hi = self.hi if other.hi <= self.hi else INF
        return Interval(lo, hi)

    def bits(self) -> Optional[Tuple[int, bool]]:
        """(bits, signed) needed, or None if unbounded (stored at 32)."""
        if not self.bounded:
            return None
        return int_bits_needed(int(self.lo), int(self.hi))

    def __repr__(self) -> str:  # pragma: no cover
        return f"[{self.lo}, {self.hi}]"


TOP = Interval.top()
BOOL = Interval(0, 1)


def input_specs(cfg, max_seq_len: int) -> Dict[str, Interval]:
    """Integer input intervals derived from a ModelConfig: the launch
    knowledge the paper seeds its analysis with, for the LM deployment.
    Token and label ids are bounded by the vocabulary, positions and
    sequence lengths by ``max_seq_len``, expert ids by the expert count.
    ``cfg`` is duck-typed (``vocab_size``, ``n_experts``)."""
    if max_seq_len < 1:
        raise ValueError(f"max_seq_len must be >= 1, got {max_seq_len}")
    specs = {
        "tokens": Interval(0, cfg.vocab_size - 1),
        "labels": Interval(0, cfg.vocab_size - 1),
        "positions": Interval(0, max_seq_len - 1),
        "len": Interval(0, max_seq_len),
    }
    if getattr(cfg, "n_experts", 0):
        specs["expert_ids"] = Interval(0, cfg.n_experts - 1)
    return specs


# ---------------------------------------------------------------------------
# transfer functions
# ---------------------------------------------------------------------------

def _mul_bound(a: float, b: float) -> float:
    if a == 0 or b == 0:
        return 0.0
    return a * b


def _arith2(a: Interval, b: Interval, op: str) -> Interval:
    if op == "add":
        return Interval(a.lo + b.lo, a.hi + b.hi)
    if op == "sub":
        return Interval(a.lo - b.hi, a.hi - b.lo)
    if op == "mul":
        cs = [_mul_bound(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
        return Interval(min(cs), max(cs))
    if op == "max":
        return Interval(max(a.lo, b.lo), max(a.hi, b.hi))
    if op == "min":
        return Interval(min(a.lo, b.lo), min(a.hi, b.hi))
    raise KeyError(op)


def _div(a: Interval, b: Interval, rounding: Callable[[float], float]
         ) -> Interval:
    """Integer division rounded by ``rounding`` (floor or trunc, both
    monotone, so the corners bound it)."""
    if b.lo <= 0 <= b.hi:           # divisor range crosses zero: give up
        return TOP
    cs = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            if math.isinf(x) or math.isinf(y):
                cs += [NEG_INF, INF]
            else:
                cs.append(rounding(x / y))
    return Interval(min(cs), max(cs))


def _rem(a: Interval, b: Interval) -> Interval:
    """Truncated remainder (``lax.rem``, ``aten.fmod``): the result's
    sign follows the dividend."""
    m = max(abs(b.lo), abs(b.hi))
    if math.isinf(m):
        return TOP
    lo = -(m - 1) if a.lo < 0 else 0.0
    hi = (m - 1) if a.hi > 0 else 0.0
    if a.lo >= 0 and a.hi < m and b.lo > 0:   # dividend already in [0, m)
        return Interval(a.lo, a.hi)
    return Interval(lo, hi)


def _remainder(a: Interval, b: Interval) -> Interval:
    """Floored remainder (``aten.remainder``, which is ``jnp.remainder``):
    its lowering, ``rem`` then a sign fix-up that selects ``r`` or
    ``r + b``, transferred as the reference transfers those primitives."""
    r = _rem(a, b)
    return r.union(_arith2(r, b, "add"))


def _rounded(a: Interval, f: Callable[[float], float]) -> Interval:
    def g(v):
        return v if math.isinf(v) else float(f(v))
    return Interval(g(a.lo), g(a.hi))


def _clamp(x: Interval, lo: Optional[Interval], hi: Optional[Interval]
           ) -> Interval:
    """clamp(x, lo, hi) = min(max(x, lo), hi)."""
    if lo is not None:
        x = _arith2(x, lo, "max")
    if hi is not None:
        x = _arith2(x, hi, "min")
    return x


def _dtype_range(dtype: torch.dtype) -> Optional[Interval]:
    if dtype == torch.bool:
        return BOOL
    if dtype.is_floating_point or dtype.is_complex:
        return None
    info = torch.iinfo(dtype)
    return Interval(float(info.min), float(info.max))


def _convert(a: Interval, dtype: Optional[torch.dtype],
             from_float: bool) -> Interval:
    """``convert_element_type``. A float source truncates toward zero;
    an integer target keeps values that fit it and wraps the others,
    so a source range past the target's gives the target's whole range
    (the reference clips instead, which a wrap-around breaks)."""
    if from_float:
        a = _rounded(a, math.trunc)
    rng = None if dtype is None else _dtype_range(dtype)
    if rng is None or (rng.lo <= a.lo and a.hi <= rng.hi):
        return a
    return rng


def _bitwise(op: str, a: Interval, b: Interval) -> Interval:
    """and/or/xor on non-negative operands stay within the operands'
    bit length; anything else is unbounded."""
    if op == "and" and (a.lo >= 0 or b.lo >= 0):
        return Interval(0, min(i.hi for i in (a, b) if i.lo >= 0))
    if a.lo >= 0 and b.lo >= 0 and a.bounded and b.bounded:
        top = (1 << int(max(a.hi, b.hi)).bit_length()) - 1
        return Interval(0, top)
    return TOP


def _value_meta(node) -> Any:
    return node.meta.get("val") if hasattr(node, "meta") else None


def _is_int(node) -> bool:
    val = _value_meta(node)
    dtype = getattr(val, "dtype", None)
    return (isinstance(dtype, torch.dtype) and dtype != torch.bool
            and not dtype.is_floating_point and not dtype.is_complex)


def _is_bool(node) -> bool:
    return getattr(_value_meta(node), "dtype", None) == torch.bool


def _shape(node) -> Tuple[int, ...]:
    return tuple(int(s) for s in _value_meta(node).shape)


def _numel(shape: Sequence[int], dims=None) -> int:
    if dims is None or dims == []:
        dims = range(len(shape))
    if isinstance(dims, int):
        dims = [dims]
    n = 1
    for d in dims:
        n *= shape[d]
    return n


def op_name(target) -> str:
    """An ATen op's name without its overload, in-place variants under
    their functional name (``index_put_`` -> ``index_put``)."""
    name = getattr(target, "_opname", getattr(target, "__name__", ""))
    if name.endswith("_") and not name.startswith("__"):
        name = name[:-1]
    return name


_PASS = frozenset({
    # shape and data movement: values unchanged (the reference's
    # broadcast_in_dim, reshape, transpose, squeeze, expand_dims, slice,
    # dynamic_slice, rev, copy, stop_gradient, gather, tile, ...)
    "view", "reshape", "_unsafe_view", "expand", "expand_copy", "permute",
    "transpose", "t", "squeeze", "unsqueeze", "slice", "select", "narrow",
    "flip", "roll", "clone", "detach", "detach_", "alias", "contiguous",
    "lift_fresh_copy", "index_select", "gather", "index", "take", "repeat",
    "tile", "flatten", "unflatten", "movedim", "as_strided", "diagonal",
    "amax", "amin", "real", "broadcast_to", "_to_copy_view",
})
_CMP = frozenset({"eq", "ne", "lt", "le", "gt", "ge", "logical_and",
                  "logical_or", "logical_not", "logical_xor", "isfinite",
                  "isnan", "isinf", "any", "all"})
_CONST_FILL = {"zeros": 0, "ones": 1, "zeros_like": 0, "ones_like": 1}


class RangeAnalysis:
    """Abstract interpreter assigning an Interval to every value of an
    exported graph (multi-output ops: a list of Intervals)."""

    def __init__(self, module: torch.nn.Module):
        self.modules = [module]      # graph modules, innermost last
        self.env: Dict[Any, Any] = {}

    # -- environment --------------------------------------------------------
    def _read(self, a) -> Interval:
        if isinstance(a, torch.fx.Node):
            v = self.env.get(a, TOP)
            return v if isinstance(v, Interval) else TOP
        if isinstance(a, bool):
            return Interval.const(float(a))
        if isinstance(a, int):
            return Interval.const(float(a))
        return TOP                   # float scalars, None, symbols

    def _write(self, node, value) -> None:
        self.env[node] = value

    def _submodule(self, node) -> torch.fx.GraphModule:
        return getattr(self.modules[-1], node.target)

    # -- the transfer of one node -------------------------------------------
    def _transfer(self, node) -> None:
        if node.op != "call_function":
            if node.op == "get_attr":
                self._write(node, TOP)
            return
        target = node.target
        if target is operator.getitem:
            src, i = node.args
            val = self.env.get(src)
            self._write(node, val[i] if isinstance(val, list)
                        and i < len(val) else TOP)
            return
        if isinstance(target, torch._ops.HigherOrderOperator):
            self._transfer_hop(node, target.name())
            return
        self._write(node, self._aten(node, op_name(target),
                                     getattr(target, "_overloadname", "")))

    def _aten(self, node, op: str, overload: str):
        args, kw = node.args, node.kwargs
        ins = [self._read(a) for a in args]
        if op in ("add", "sub", "rsub"):
            b = ins[1]
            alpha = kw.get("alpha", args[2] if len(args) > 2 else 1)
            if alpha != 1:
                b = _arith2(b, self._read(alpha), "mul")
            if op == "rsub":
                return _arith2(b, ins[0], "sub")
            return _arith2(ins[0], b, op)
        if op == "mul":
            return _arith2(ins[0], ins[1], "mul")
        if op in ("maximum", "minimum", "fmax", "fmin"):
            return _arith2(ins[0], ins[1], "max" if "max" in op else "min")
        if op in ("max", "min"):
            if overload == "other":
                return _arith2(ins[0], ins[1], op)
            if overload == "dim":                    # (values, indices)
                n = _shape(args[0])[args[1]]
                return [ins[0], Interval(0, max(n - 1, 0))]
            return ins[0]
        if op == "floor_divide":
            return _div(ins[0], ins[1], math.floor)
        if op == "div":
            mode = kw.get("rounding_mode")
            if mode == "floor":
                return _div(ins[0], ins[1], math.floor)
            if mode == "trunc":
                return _div(ins[0], ins[1], math.trunc)
            return TOP                               # true division
        if op == "fmod":
            return _rem(ins[0], ins[1])
        if op == "remainder":
            return _remainder(ins[0], ins[1])
        if op == "floor":
            return _rounded(ins[0], math.floor)
        if op == "ceil":
            return _rounded(ins[0], math.ceil)
        if op == "trunc":
            return _rounded(ins[0], math.trunc)
        if op == "round":
            a = ins[0]
            return _rounded(a, math.floor).union(_rounded(a, math.ceil))
        if op == "neg":
            return Interval(-ins[0].hi, -ins[0].lo)
        if op in ("abs", "absolute"):
            a = ins[0]
            lo = 0.0 if a.lo <= 0 <= a.hi else min(abs(a.lo), abs(a.hi))
            return Interval(lo, max(abs(a.lo), abs(a.hi)))
        if op in ("sign", "sgn"):
            return Interval(-1, 1)
        if op == "clamp":
            lo = args[1] if len(args) > 1 else kw.get("min")
            hi = args[2] if len(args) > 2 else kw.get("max")
            return _clamp(ins[0], None if lo is None else self._read(lo),
                          None if hi is None else self._read(hi))
        if op == "clamp_min":
            return _clamp(ins[0], ins[1], None)
        if op == "clamp_max":
            return _clamp(ins[0], None, ins[1])
        if op == "arange":                           # iota
            n = _numel(_shape(node))
            start = args[0] if overload in ("start", "start_step") else 0
            step = args[2] if overload == "start_step" else kw.get("step", 1)
            if not all(isinstance(v, int) for v in (start, step)):
                return TOP
            last = start + step * max(n - 1, 0)
            return Interval(min(start, last), max(start, last))
        if op in ("argmax", "argmin"):
            dim = args[1] if len(args) > 1 else kw.get("dim")
            n = _numel(_shape(args[0]), dim)
            return Interval(0, max(n - 1, 0))
        if op in ("topk", "sort"):                   # (values, indices)
            dim = -1
            if op == "topk":
                dim = args[2] if len(args) > 2 else kw.get("dim", -1)
            elif len(args) > 1 and isinstance(args[1], int):
                dim = args[1]
            n = _shape(args[0])[dim]
            return [ins[0], Interval(0, max(n - 1, 0))]
        if op in _PASS:
            return ins[0]
        if op in ("to", "_to_copy", "type", "convert_element_type"):
            dtype = kw.get("dtype")
            if dtype is None:
                dtype = next((a for a in args[1:]
                              if isinstance(a, torch.dtype)), None)
            src = _value_meta(args[0])
            return _convert(ins[0], dtype, bool(getattr(
                getattr(src, "dtype", None), "is_floating_point", False)))
        if op in ("cat", "concat", "concatenate", "stack"):
            itv = None
            for x in args[0]:
                r = self._read(x)
                itv = r if itv is None else itv.union(r)
            return itv or TOP
        if op == "where":                            # select_n
            return ins[1].union(ins[2])
        if op in ("constant_pad_nd", "pad"):
            value = args[2] if len(args) > 2 else kw.get("value", 0)
            return ins[0].union(self._read(value if value is not None
                                           else 0))
        if op in ("slice_scatter", "select_scatter", "index_put",
                  "scatter", "copy"):                # dynamic_update_slice
            src = args[2] if op == "index_put" else args[1]
            if op == "scatter" and len(args) > 3:
                src = args[3]
            return ins[0].union(self._read(src))
        if op == "sum":                              # reduce_sum
            dims = args[1] if len(args) > 1 else kw.get("dim")
            n = _numel(_shape(args[0]), dims)
            a = ins[0]
            return Interval(_mul_bound(a.lo, n), _mul_bound(a.hi, n))
        if op in _CMP:
            return BOOL
        if op in ("bitwise_and", "bitwise_or", "bitwise_xor", "__and__",
                  "__or__", "__xor__"):
            if all(_is_bool(a) for a in args[:2]
                   if isinstance(a, torch.fx.Node)):
                return BOOL
            return _bitwise(op.strip("_").replace("bitwise_", ""),
                            ins[0], ins[1])
        if op == "bitwise_not":
            a = ins[0]
            return BOOL if _is_bool(args[0]) else Interval(-a.hi - 1,
                                                           -a.lo - 1)
        if op in ("bitwise_left_shift", "__lshift__"):
            a, s = ins[0], ins[1]
            if s.bounded and a.bounded and s.lo >= 0:
                return Interval(
                    min(a.lo * 2 ** int(s.lo), a.lo * 2 ** int(s.hi)),
                    max(a.hi * 2 ** int(s.lo), a.hi * 2 ** int(s.hi)))
            return TOP
        if op in ("bitwise_right_shift", "__rshift__"):
            a, s = ins[0], ins[1]
            if a.lo >= 0 and s.bounded and s.lo >= 0:
                return Interval(a.lo // 2 ** int(s.hi),
                                a.hi // 2 ** int(s.lo))
            return a if a.bounded else TOP
        if op in _CONST_FILL:
            return Interval.const(_CONST_FILL[op])
        if op in ("full", "full_like", "new_full"):
            return self._read(args[1] if len(args) > 1 else kw.get(
                "fill_value"))
        if op == "scalar_tensor":
            return self._read(args[0])
        # unknown op: the sound default (multi-output ops read it through
        # getitem, which falls back to top too)
        return TOP

    # -- structured control flow --------------------------------------------
    def _run_subgraph(self, gm: torch.fx.GraphModule,
                      in_itvs: Sequence[Interval]) -> List[Interval]:
        saved = self.env
        self.env = dict(saved)
        self.modules.append(gm)
        placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
        for node, itv in zip(placeholders, in_itvs):
            self._write(node, itv)
        results: List[Interval] = []
        for node in gm.graph.nodes:
            if node.op == "output":
                outs = node.args[0]
                if not isinstance(outs, (list, tuple)):
                    outs = [outs]
                results = [self._read(o) for o in outs]
            else:
                self._transfer(node)
        self.modules.pop()
        # surface inner intervals for reporting, then restore scope
        inner = self.env
        self.env = saved
        for k, v in inner.items():
            self.env.setdefault(k, v)
        return results

    def _fixpoint(self, run: Callable[[List[Interval]], List[Interval]],
                  carry: List[Interval], max_iters: int = 8
                  ) -> List[Interval]:
        """Widen-then-narrow loop analysis: ``run(carry)`` is the body's
        transfer, its first ``len(carry)`` results the next carry."""
        init = list(carry)
        for it in range(max_iters):
            new_carry = run(carry)[:len(carry)]
            merged = [c.union(n) for c, n in zip(carry, new_carry)]
            if it >= max_iters // 2:                 # start widening late
                merged = [c.widen(m) for c, m in zip(carry, merged)]
            if all(m.lo == c.lo and m.hi == c.hi
                   for m, c in zip(merged, carry)):
                break
            carry = merged
        # narrowing: re-run the body from the post-widening state; bounds
        # the body itself clamps tighten back down
        for _ in range(2):
            results = run(carry)
            carry = [i0.union(n) for i0, n in zip(init, results[:len(carry)])]
        return carry

    def _transfer_hop(self, node, name: str) -> None:
        args = node.args
        if name == "while_loop":
            # (cond, body, carried, additional): body(*carried, *additional)
            body = self._submodule(args[1])
            carry = [self._read(a) for a in args[2]]
            extra = [self._read(a) for a in args[3]] if len(args) > 3 else []
            carry = self._fixpoint(
                lambda c: self._run_subgraph(body, c + extra), carry)
            self._write(node, carry)
        elif name == "scan":
            # (combine, init, xs, additional): combine(*carry, *x_t,
            # *additional) -> (*next carry, *y_t); a slice of xs has the
            # interval of xs, the stacked ys that of each y_t
            body = self._submodule(args[0])
            carry = [self._read(a) for a in args[1]]
            xs = [self._read(a) for a in args[2]]
            extra = [self._read(a) for a in args[3]] if len(args) > 3 else []
            carry = self._fixpoint(
                lambda c: self._run_subgraph(body, c + xs + extra), carry)
            ys = self._run_subgraph(body, carry + xs + extra)[len(carry):]
            self._write(node, carry + ys)
        elif name == "cond":
            # (pred, true_fn, false_fn, operands)
            ins = [self._read(a) for a in args[3]]
            outs: Optional[List[Interval]] = None
            for br in args[1:3]:
                res = self._run_subgraph(self._submodule(br), ins)
                outs = res if outs is None else [a.union(b) for a, b
                                                 in zip(outs, res)]
            self._write(node, outs or [])
        elif name == "wrap_with_set_grad_enabled":
            res = self._run_subgraph(self._submodule(args[1]),
                                     [self._read(a) for a in args[2:]])
            self._write(node, res)
        else:
            self._write(node, TOP)


@dataclasses.dataclass
class RangeReport:
    """Per-value intervals and bitwidths of one traced function."""

    intervals: Dict[str, Interval]
    out_intervals: List[Interval]

    def bits_for(self, name: str) -> Optional[Tuple[int, bool]]:
        return self.intervals[name].bits()

    def narrow_values(self, max_bits: int = 16) -> Dict[str, Tuple[int, bool]]:
        res = {}
        for name, itv in self.intervals.items():
            b = itv.bits()
            if b and b[0] <= max_bits:
                res[name] = b
        return res


class _Traced(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _constant_interval(value) -> Interval:
    """A lifted constant's exact range (integer tensors), else top."""
    if (isinstance(value, torch.Tensor) and value.numel()
            and not value.is_floating_point() and not value.is_complex()):
        return Interval(float(value.min()), float(value.max()))
    return TOP


def analyze(fn: Callable, *example_args,
            input_ranges: Optional[Sequence[Optional[Interval]]] = None
            ) -> RangeReport:
    """Export ``fn`` at the example arguments' shapes and run the
    interval analysis.

    ``input_ranges[i]`` bounds the i-th (flattened) tensor argument; None
    leaves it unbounded (float arguments too). This metadata plays the
    role the paper gives to kernel-launch knowledge (tid bounds etc.).
    """
    from torch.export import export
    from torch.export.graph_signature import InputKind, OutputKind

    ep = export(_Traced(fn), tuple(example_args), strict=False)
    gm = ep.graph_module
    sig = ep.graph_signature
    ra = RangeAnalysis(gm)
    flat_ranges = list(input_ranges or [])
    placeholders = {n.name: n for n in gm.graph.nodes
                    if n.op == "placeholder"}
    n_user = 0
    for spec in sig.input_specs:
        node = placeholders[spec.arg.name]
        if spec.kind == InputKind.USER_INPUT:
            itv = (flat_ranges[n_user] if n_user < len(flat_ranges) else None)
            n_user += 1
            ra._write(node, itv or TOP)
        elif spec.kind == InputKind.CONSTANT_TENSOR:
            ra._write(node, _constant_interval(ep.constants[spec.target]))
        else:
            ra._write(node, TOP)
    outs: List[Any] = []
    for node in gm.graph.nodes:
        if node.op == "output":
            outs = list(node.args[0])
        elif node.op != "placeholder":
            ra._transfer(node)
    out_intervals = [ra._read(o) for o, spec in zip(outs, sig.output_specs)
                     if spec.kind == OutputKind.USER_OUTPUT]

    intervals: Dict[str, Interval] = {}
    for node, itv in ra.env.items():
        if isinstance(itv, Interval) and _is_int(node):
            key = node.name
            while key in intervals:           # uniquify across sub-graphs
                key += "'"
            intervals[key] = itv
    return RangeReport(intervals=intervals, out_intervals=out_intervals)
