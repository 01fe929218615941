"""Pass 1: static activation range inference -> per-layer KV widths.

Port of ``repro.analysis.activations``. The paper's range analysis
(Section 4.2) is integer-only; the KV cache stores *float* activations,
so this pass extends the interval abstract interpretation of
``core.range_analysis`` (over exported ATen graphs) to float magnitude
bounds and walks them through the KV-producing slice of the transformer
body.

The interval domain is non-relational, so it cannot bound ``rms_norm``
through a graph alone (``x * rsqrt(mean(x^2))`` needs the relation
between numerator and denominator). The norm's envelope *is* provable as
a host-side lemma: ``|x_i| <= sqrt(d) * (1 + max|scale|)`` because
``x_i^2 <= sum x^2 = d * mean(x^2)``. The pass seeds the exported K/V
projection ``xn @ Wk, xn @ Wv`` with that envelope (from the actual
norm-scale values) and with per-layer weight intervals, runs
``FloatRangeAnalysis`` over it, then applies two more host-side lemmas
on the K stream: ``qk_norm`` re-normalizes K (its bound becomes the
head-dim envelope) and RoPE's rotation at most doubles a coordinate
bound (``|x1 cos - x2 sin| <= |x1| + |x2|``).

The proven per-layer bound maps to the narrowest Table 3 float format
whose ``max_finite`` clears it: a width below that is a *silent clipping
proof* (the encoder saturates to the format max). The width never goes
below ``floor_bits`` (default: the config's own KV width, so the static
plan can widen an unsound config but narrows only when asked to).

The projection is exported once per call from its shapes (fake tensors:
no values, no memory), and each layer's analysis reads that graph. The
leaves' magnitudes are read with torch on the leaves' own device.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.analysis.report import Finding
from repro_torch.core.formats import FLOAT_FORMATS, FLOAT_LADDER
from repro_torch.core.range_analysis import (INF, NEG_INF, TOP, Interval,
                                             RangeAnalysis, _Traced,
                                             _constant_interval, _mul_bound)

_KV_FAMILIES = ("dense", "vlm", "moe")
_EXP_SAFE = 700.0          # exp overflows f64 past ~709; cut early
_MATMULS = ("mm", "matmul", "bmm", "linear")


def _float_div(a: Interval, b: Interval) -> Interval:
    """Real division (no integer floor: the parent's ``_div`` rounds
    both bounds, which is unsound for a float upper bound)."""
    if b.lo <= 0 <= b.hi:
        return TOP
    cs: List[float] = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            if math.isinf(x) or math.isinf(y):
                cs.extend((NEG_INF, INF))
            else:
                cs.append(x / y)
    return Interval(min(cs), max(cs))


def _power(a: Interval, y: int) -> Interval:
    """``x ** y`` for an integer exponent y >= 0."""
    if y < 0 or math.isinf(a.lo) or math.isinf(a.hi):
        return TOP
    cs = [a.lo ** y, a.hi ** y]
    if y % 2 == 0:
        lo = 0.0 if a.lo <= 0 <= a.hi else min(cs)
        return Interval(lo, max(cs))
    return Interval(min(cs), max(cs))


def _literal(value) -> Optional[Interval]:
    """A finite float literal or lifted constant as a real interval."""
    if isinstance(value, float) and math.isfinite(value):
        return Interval.const(value)
    if (isinstance(value, torch.Tensor) and value.numel()
            and value.is_floating_point()
            and bool(torch.isfinite(value).all())):
        return Interval(float(value.min()), float(value.max()))
    return None


class FloatRangeAnalysis(RangeAnalysis):
    """Interval abstract interpretation over float values too.

    Inherits every integer transfer (they are sound over the reals:
    add/sub/mul corner arithmetic, union joins, the widen-then-narrow
    loop fixpoint) and adds the float ones of the reference's jaxpr
    primitives, on the ATen ops that compute them: float literals become
    real intervals, true division loses the integer floor, and ``exp``
    (cut at 700), ``log``, ``tanh``, ``sigmoid``, ``erf``, ``sin``,
    ``cos``, ``sqrt``, ``rsqrt``, integer ``pow`` and ``square`` get
    monotone-envelope transfers; ``mm`` / ``matmul`` / ``bmm`` /
    ``linear`` get K times the largest corner product (0 for an empty
    contraction). Unknown ops still fall to top: the analysis is
    conservative, never wrong."""

    def _read(self, a) -> Interval:
        if isinstance(a, float) and not isinstance(a, bool):
            itv = _literal(a)
            return itv if itv is not None else TOP
        return super()._read(a)

    def _aten(self, node, op: str, overload: str):
        args, kw = node.args, node.kwargs
        if op == "div" and kw.get("rounding_mode") is None:
            return _float_div(self._read(args[0]), self._read(args[1]))
        if op not in ("exp", "log", "tanh", "sigmoid", "erf", "sin", "cos",
                      "sqrt", "rsqrt", "pow", "square") + _MATMULS:
            return super()._aten(node, op, overload)
        a = self._read(args[0])
        if op == "exp":
            lo = 0.0 if a.lo == NEG_INF else math.exp(min(a.lo, _EXP_SAFE))
            hi = INF if a.hi > _EXP_SAFE else math.exp(a.hi)
            return Interval(lo, hi)
        if op == "log":
            if a.lo > 0:
                return Interval(math.log(a.lo), INF if math.isinf(a.hi)
                                else math.log(a.hi))
            return TOP
        if op in ("tanh", "erf", "sin", "cos"):
            return Interval(-1.0, 1.0)
        if op == "sigmoid":
            return Interval(0.0, 1.0)
        if op == "sqrt":
            if a.hi < 0:
                return TOP                     # NaN domain: no claim
            lo = math.sqrt(a.lo) if a.lo > 0 else 0.0
            return Interval(lo, INF if math.isinf(a.hi) else math.sqrt(a.hi))
        if op == "rsqrt":
            if a.lo > 0:
                return Interval(0.0 if math.isinf(a.hi)
                                else 1.0 / math.sqrt(a.hi),
                                1.0 / math.sqrt(a.lo))
            return TOP                         # zero-crossing: unbounded
        if op == "square":
            return _power(a, 2)
        if op == "pow":
            y = args[1] if len(args) > 1 else kw.get("exponent")
            if overload == "Tensor_Scalar" and isinstance(y, int) \
                    and not isinstance(y, bool):
                return _power(a, y)
            return TOP
        return self._matmul(node, op, a, self._read(args[1]))

    def _matmul(self, node, op: str, a: Interval, b: Interval) -> Interval:
        """out = a sum over K contracted products: |out| <= K x the
        largest corner product of the operand intervals; ``linear`` adds
        its bias."""
        k = int(node.args[0].meta["val"].shape[-1])
        if k == 0:
            out = Interval.const(0.0)
        else:
            cs = [_mul_bound(x, y) for x in (a.lo, a.hi) for y in (b.lo, b.hi)]
            out = Interval(_mul_bound(float(k), min(cs)),
                           _mul_bound(float(k), max(cs)))
        if op == "linear":
            bias = node.args[2] if len(node.args) > 2 else node.kwargs.get(
                "bias")
            if bias is not None:
                bi = self._read(bias)
                out = Interval(out.lo + bi.lo, out.hi + bi.hi)
        return out


def run_float_analysis(ep, seeds) -> List[Interval]:
    """``FloatRangeAnalysis`` over an exported program: the i-th user
    input starts at ``seeds[i]`` (top past the end), lifted constants at
    their real range; returns the user outputs' intervals."""
    from torch.export.graph_signature import InputKind, OutputKind

    gm = ep.graph_module
    ra = FloatRangeAnalysis(gm)
    placeholders = {n.name: n for n in gm.graph.nodes
                    if n.op == "placeholder"}
    n_user = 0
    for spec in ep.graph_signature.input_specs:
        node = placeholders[spec.arg.name]
        itv = None
        if spec.kind == InputKind.USER_INPUT:
            itv = seeds[n_user] if n_user < len(seeds) else None
            n_user += 1
        elif spec.kind == InputKind.CONSTANT_TENSOR:
            value = ep.constants[spec.target]
            itv = _literal(value) or _constant_interval(value)
        ra._write(node, itv or TOP)
    outs: List[Any] = []
    for node in gm.graph.nodes:
        if node.op == "output":
            outs = list(node.args[0])
        elif node.op != "placeholder":
            ra._transfer(node)
    return [ra._read(o) for o, spec in zip(outs, ep.graph_signature
                                           .output_specs)
            if spec.kind == OutputKind.USER_OUTPUT]


def export_shapes(fn, *shapes, dtype=torch.float32):
    """``torch.export`` of ``fn`` over fake tensors of ``shapes`` on the
    CPU: the graph from shapes alone, no values and no memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        args = tuple(torch.zeros(s, dtype=dtype) for s in shapes)
    return torch.export.export(_Traced(fn), args, strict=False)


def width_for_bound(bound: float, floor_bits: int = FLOAT_LADDER[0]) -> int:
    """Narrowest Table 3 rung whose ``max_finite`` clears ``bound`` (an
    unbounded proof keeps full width), floored at ``floor_bits``."""
    if math.isinf(bound) or math.isnan(bound):
        return 32
    for b in FLOAT_LADDER:
        if b >= floor_bits and FLOAT_FORMATS[b].max_finite >= bound:
            return b
    return 32


def _abs_max(t: torch.Tensor) -> float:
    return float(t.detach().abs().max()) if t.numel() else 0.0


def _layer_leaf(blocks: Dict, names: Tuple[str, ...],
                layer: int) -> torch.Tensor:
    node: Any = blocks
    for n in names:
        node = node[n]
    return node[layer]


def _project(xn, wk, wv):
    return xn @ wk, xn @ wv


def _analyze_projection(ep, x_bound: float, wk_max: float,
                        wv_max: float) -> Tuple[Interval, Interval]:
    """``FloatRangeAnalysis`` over the exported K/V projection with the
    host-lemma input envelopes; the two output intervals."""
    k_itv, v_itv = run_float_analysis(ep, (
        Interval(-x_bound, x_bound),
        Interval(-wk_max, wk_max),
        Interval(-wv_max, wv_max),
    ))
    return k_itv, v_itv


def infer_kv_widths(
    cfg,
    params: Optional[Dict] = None,
    floor_bits: Optional[int] = None,
) -> Tuple[Dict[str, int], Dict[str, float], List[Finding]]:
    """Per-layer KV widths for ``cfg``: ``({"kv/layer_i": bits},
    {"kv/layer_i": proven bound}, findings)``.

    ``params`` is the *dense* parameter tree (initialized fresh when
    omitted; a deployment passes its checkpoint); only
    the attention leaves ``ln``, ``wk``, ``wv`` and ``k_norm`` are read.
    ``floor_bits`` defaults to the config's own KV width, so the default
    inference can widen an overflow-unsafe config but never narrows
    below it without an explicit opt-in."""
    findings: List[Finding] = []
    if cfg.family not in _KV_FAMILIES:
        findings.append(Finding(
            check="activation_width", severity="info",
            message=(
                f"family {cfg.family!r} is outside the per-layer KV "
                "width domain (single stacked decode scan families "
                "only); keeping the uniform config width"),
        ))
        return {}, {}, findings
    if params is None:
        from repro_torch.models.lm import LM
        params = LM(cfg).init()

    d = cfg.d_model
    hd = cfg.resolved_head_dim
    blocks = params["blocks"]
    attn = blocks["attn"]
    floor = floor_bits if floor_bits is not None else (
        cfg.compression.kv_bits or 16)
    ep = export_shapes(_project, (1, d), (d, attn["wk"].shape[-1]),
                       (d, attn["wv"].shape[-1]))

    kv_bits: Dict[str, int] = {}
    kv_bounds: Dict[str, float] = {}
    for layer in range(cfg.n_kv_layers):
        # static envelope of the pre-projection rms_norm (host lemma:
        # |xn_i| <= sqrt(d) * (1 + max|scale|), scales from the actual
        # values)
        ln_scale = _abs_max(_layer_leaf(blocks, ("attn", "ln"), layer))
        x_bound = math.sqrt(d) * (1.0 + ln_scale)
        wk_max = _abs_max(_layer_leaf(blocks, ("attn", "wk"), layer))
        wv_max = _abs_max(_layer_leaf(blocks, ("attn", "wv"), layer))

        k_itv, v_itv = _analyze_projection(ep, x_bound, wk_max, wv_max)
        k_bound = max(abs(k_itv.lo), abs(k_itv.hi))
        v_bound = max(abs(v_itv.lo), abs(v_itv.hi))
        if cfg.qk_norm:
            # host lemma: K is rms-normalized per head after projection;
            # the projection bound is superseded by the head-dim envelope
            kn_scale = _abs_max(
                _layer_leaf(blocks, ("attn", "k_norm"), layer))
            k_bound = math.sqrt(hd) * (1.0 + kn_scale)
        # host lemma: RoPE rotates coordinate pairs,
        # |x1 cos - x2 sin| <= |x1| + |x2| <= 2 * bound
        k_bound *= 2.0
        bound = max(k_bound, v_bound)
        key = f"kv/layer_{layer}"
        kv_bounds[key] = bound
        bits = width_for_bound(bound, floor)
        kv_bits[key] = bits
        if math.isinf(bound):
            findings.append(Finding(
                check="activation_width", severity="warning", path=key,
                message=(
                    f"layer {layer}: KV magnitude bound did not "
                    "converge (top); emitting full width"),
            ))
        elif bits > (cfg.compression.kv_bits or 16):
            findings.append(Finding(
                check="activation_width", severity="warning", path=key,
                message=(
                    f"layer {layer}: proven KV bound {bound:.4g} "
                    f"exceeds max_finite of the configured "
                    f"{cfg.compression.kv_bits or 16}-bit format; "
                    f"plan widens to AF{bits}"),
                detail={"bound": bound, "config_bits":
                        cfg.compression.kv_bits or 16, "plan_bits": bits},
            ))
    findings.append(Finding(
        check="activation_width", severity="info",
        message=(
            f"proved KV bounds for {len(kv_bits)} layers "
            f"(floor AF{floor}); widths "
            f"{sorted(set(kv_bits.values()))}"),
        detail={"floor_bits": floor},
    ))
    return kv_bits, kv_bounds, findings


def kv_plan_entries(cfg, params: Optional[Dict] = None,
                    floor_bits: Optional[int] = None) -> Dict[str, int]:
    """Just the ``kv_bits`` dict (the ``CompressionPlan`` family), for
    callers that want the plan entries without the findings."""
    bits, _, _ = infer_kv_widths(cfg, params=params, floor_bits=floor_bits)
    return bits
