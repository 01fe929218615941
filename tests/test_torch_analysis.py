"""The port's static-analysis gate (``repro_torch.analysis``) against the
reference's (``repro.analysis``), on the CPU, for reduced qwen3_8b.

The port lints the reference's parameters (``LM(cfg).init(prng_key(0))``
carried across with ``interop.params_from_numpy``) on ``device="cpu"``
(the plain versions of the kernels); each package's ``run_lint`` runs
once, in a module fixture. Held:

  * the reports: the same ``clean``, ``passes``, ``counters`` and
    ``kv_bits``, ``kv_bounds`` within 1e-12 relative, the same multiset
    of (check, severity, path); message texts may differ;
  * activations: ``width_for_bound`` over a grid, the float transfers
    against the reference's on the same functions, and a soundness
    property against sampled values;
  * plan soundness: the broken fixture's error paths, the KV overflow;
  * dispatch: the entry points run, the seeded fallback's spec, shape,
    width and candidates, the card's refusal turned into the same error,
    a wholesale decode of a planned matrix, records seen before the
    window;
  * the sharding rules, as tuples, for every packed leaf of every zoo
    config's reduced tree at TP 2, 4 and 8, outside a mesh and inside an
    abstract ("data", "model") mesh;
  * donation: ``decode_step`` has no hazard, a hand-built read after an
    overwrite is flagged and one without such a read is not;
  * reports under both validators, the CLI's exit codes and its emitted
    KV plan (the reference CLI's bytes), and the inferred KV plan served
    by the port's engine (the constant-width engine's greedy tokens).
"""
from __future__ import annotations

import collections
import json
import math
import os
import types
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.analysis.lint as ref_lint_module
from repro.analysis.activations import FloatRangeAnalysis as RefFloatRA
from repro.analysis.activations import width_for_bound as ref_width_for_bound
from repro.analysis.dispatch import lint_dispatch as ref_lint_dispatch
from repro.analysis.lint import _inject_fallback as ref_inject_fallback
from repro.analysis.lint import run_lint as ref_run_lint
from repro.analysis.soundness import lint_plan as ref_lint_plan
from repro.compat import prng_key
from repro.configs import get_config as ref_get_config
from repro.core.compress import CompressionPlan as RefPlan
from repro.core.range_analysis import Interval as RefInterval
from repro.distributed import sharding as ref_sharding
from repro.models.lm import LM as RefLM
from repro.obs.schema import validate_lint_report as ref_validate_lint

from repro_torch import obs
from repro_torch.analysis import lint as lint_module
from repro_torch.analysis.activations import (FloatRangeAnalysis,
                                              export_shapes,
                                              run_float_analysis,
                                              width_for_bound)
from repro_torch.analysis.dispatch import lint_dispatch
from repro_torch.analysis.lint import _inject_fallback, run_lint
from repro_torch.analysis.report import Finding, LintReport
from repro_torch.analysis.sharding_lint import (donation_hazards,
                                                functional_graph,
                                                lint_donation)
from repro_torch.analysis.soundness import lint_plan
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.compress import CompressionPlan, uniform_plan
from repro_torch.core.formats import FLOAT_FORMATS, FLOAT_LADDER, decode_float
from repro_torch.core.range_analysis import Interval
from repro_torch.core.tensor_store import pack_tensor
from repro_torch.distributed import sharding
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.layers import FusedPathRefused
from repro_torch.obs import validate as validate_cli
from repro_torch.obs.schema import validate_lint_report
from repro_torch.serving import ServeEngine
from test_torch_serve import (_jitted_repack, _numpy_tree,  # noqa: F401
                              one_torch_thread)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "broken_plan.json")
ENTRY_POINTS = {"decode_step", "paged_decode_step", "prefill_step",
                "verify_step", "train_loss"}


@pytest.fixture(scope="module")
def cfg():
    return get_config("qwen3_8b").reduced()


@pytest.fixture(scope="module")
def ref_params():
    return RefLM(ref_get_config("qwen3_8b").reduced()).init(prng_key(0))


@pytest.fixture(scope="module")
def params(ref_params):
    return params_from_numpy(_numpy_tree(ref_params), device="cpu")


_REF_PACKED = {}


def ref_repack_once(tree, plan):
    """The reference's ``repack``, jitted and done once per tree and
    plan: the same integer programs, without ~20 s of packing at eager
    speed (its ``run_lint`` packs the same tree twice)."""
    key = (id(tree), json.dumps(plan.to_jsonable(), sort_keys=True))
    if key not in _REF_PACKED:
        _REF_PACKED[key] = (tree, _jitted_repack(tree, plan))
    return _REF_PACKED[key][1]


def ref_lint(arch: str, **kw):
    """The reference's ``run_lint`` of a reduced config."""
    with mock.patch("repro.analysis.dispatch.repack", ref_repack_once), \
            mock.patch("repro.analysis.sharding_lint.repack",
                       ref_repack_once):
        return ref_run_lint(ref_get_config(arch).reduced(), arch, **kw)


@pytest.fixture(scope="module")
def ref_report():
    return ref_lint("qwen3_8b")


@pytest.fixture(scope="module")
def report(cfg, params):
    return run_lint(cfg, "qwen3_8b", device="cpu", params=params)


def _triples(findings):
    return collections.Counter((f.check, f.severity, f.path)
                               for f in findings)


def assert_reports_agree(got, want):
    """The port's report against the reference's: verdicts, counters,
    widths, bounds (1e-12 relative) and findings up to their text."""
    assert got.clean == want.clean
    assert got.passes == want.passes
    assert got.counts() == want.counts()
    assert got.kv_bits == want.kv_bits
    assert set(got.kv_bounds) == set(want.kv_bounds)
    for key, bound in want.kv_bounds.items():
        assert math.isclose(got.kv_bounds[key], bound, rel_tol=1e-12), key
    assert _triples(got.findings) == _triples(want.findings)


# ------------------------------------------------------------------ reports

def test_report_matches_reference(report, ref_report):
    assert_reports_agree(report, ref_report)
    assert report.clean and len(report.findings) == 5
    assert set(report.kv_bits.values()) == {16}


# ------------------------------------------------------------ activations

def test_width_for_bound_matches_reference():
    bounds = [0.0, 1e-3, 1.0, 15.0, 15.5, 15.51, 255.0, 510.0, 6.0e4,
              65504.0, 65505.0, 1e10, 3.4e38, float("inf"), float("nan")]
    bounds += [FLOAT_FORMATS[b].max_finite for b in FLOAT_LADDER]
    for b in bounds:
        for floor in FLOAT_LADDER:
            assert width_for_bound(b, floor) == ref_width_for_bound(b, floor)
    assert width_for_bound(1.0) == FLOAT_LADDER[0]


def _ref_interval(fn, args, seeds):
    closed = jax.make_jaxpr(fn)(*args)
    ra = RefFloatRA()
    for v, itv in zip(closed.jaxpr.invars, seeds):
        ra._write(v, RefInterval(itv.lo, itv.hi))
    for v in closed.jaxpr.constvars:
        ra._write(v, RefInterval.top())
    for eqn in closed.jaxpr.eqns:
        ra._transfer(eqn)
    return ra._read(closed.jaxpr.outvars[0])


# each: (the port's function, the reference's, input shapes, seeds)
_TRANSFERS = {
    "exp_of_top": (torch.exp, jnp.exp, [()], [Interval.top()]),
    "exp_cut": (torch.exp, jnp.exp, [()], [Interval(-3.0, 800.0)]),
    "log": (torch.log, jnp.log, [()], [Interval(0.5, 40.0)]),
    "log_zero": (torch.log, jnp.log, [()], [Interval(0.0, 4.0)]),
    "rsqrt_zero_crossing": (torch.rsqrt, jax.lax.rsqrt, [()],
                            [Interval(-1.0, 1.0)]),
    "rsqrt": (torch.rsqrt, jax.lax.rsqrt, [()], [Interval(0.25, 9.0)]),
    "sqrt": (torch.sqrt, jnp.sqrt, [()], [Interval(-1.0, 16.0)]),
    "recip_zero_crossing": (lambda x: 1.0 / x, lambda x: 1.0 / x, [()],
                            [Interval(-1.0, 1.0)]),
    "div": (lambda x: x / 4.0, lambda x: x / 4.0, [()],
            [Interval(-3.0, 5.0)]),
    "floor": (torch.floor, jnp.floor, [()], [Interval(-2.5, 3.5)]),
    "tanh_sigmoid": (lambda x: torch.tanh(x) + torch.sigmoid(x),
                     lambda x: jnp.tanh(x) + jax.nn.sigmoid(x), [()],
                     [Interval(-5.0, 5.0)]),
    "sin_cos_erf": (lambda x: torch.sin(x) * torch.cos(x) + torch.erf(x),
                    lambda x: (jnp.sin(x) * jnp.cos(x)
                               + jax.lax.erf(x)), [()],
                    [Interval(-5.0, 5.0)]),
    "pow3_square": (lambda x: x ** 3 + torch.square(x),
                    lambda x: x ** 3 + jnp.square(x), [()],
                    [Interval(-2.0, 3.0)]),
    "matmul": (lambda x, w: x @ w, lambda x, w: x @ w, [(2, 6), (6, 3)],
               [Interval(-2.0, 3.0), Interval(-0.5, 0.25)]),
    "empty_contraction": (lambda x, w: x @ w, lambda x, w: x @ w,
                          [(2, 0), (0, 3)],
                          [Interval(-2.0, 3.0), Interval(-1.0, 1.0)]),
}


@pytest.mark.parametrize("case", sorted(_TRANSFERS))
def test_float_transfers_match_reference(case):
    fn, ref_fn, shapes, seeds = _TRANSFERS[case]
    got = run_float_analysis(export_shapes(fn, *shapes), seeds)[0]
    want = _ref_interval(ref_fn, [jnp.zeros(s, jnp.float32) for s in shapes],
                         seeds)
    assert (got.lo, got.hi) == (want.lo, want.hi)


def test_float_analysis_keeps_unknown_ops_at_top():
    ep = export_shapes(lambda x: torch.atan(x), ())
    itv = run_float_analysis(ep, [Interval(-1.0, 1.0)])[0]
    assert math.isinf(itv.lo) and math.isinf(itv.hi)
    assert isinstance(FloatRangeAnalysis(ep.graph_module)._read(2.5),
                      Interval)


@settings(max_examples=10, deadline=None)
@given(st.floats(min_value=-50.0, max_value=50.0, allow_nan=False,
                 allow_infinity=False),
       st.floats(min_value=0.0, max_value=50.0, allow_nan=False,
                 allow_infinity=False))
def test_float_transfer_soundness(center, radius):
    """The abstract output holds every concrete output for inputs drawn
    inside the seeded intervals (a transcendental and matmul chain)."""
    lo, hi = center - radius, center + radius

    def f(x, w):
        h = torch.tanh(x) @ w
        return h + torch.sqrt(torch.abs(h) + 1.0) - torch.exp(-x).sum()

    itv = run_float_analysis(export_shapes(f, (2, 4), (4, 3)),
                             [Interval(lo, hi), Interval(-2.0, 2.0)])[0]
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.uniform(lo, hi, (2, 4)))
    ws = torch.from_numpy(rng.uniform(-2.0, 2.0, (4, 3)))
    out = f(xs, ws)
    assert itv.lo <= float(out.min()) + 1e-5
    assert itv.hi >= float(out.max()) - 1e-5


def test_half_decode_exports_bit_for_bit():
    """AF16's decode (float16 lanes, NaNs made canonical) has no branch
    on data that stops ``torch.export``; the exported program gives the
    eager decode's bits on every AF16 code."""
    codes = torch.arange(1 << 16, dtype=torch.int32)
    fmt = FLOAT_FORMATS[16]
    ep = export_shapes(lambda c: decode_float(c, fmt), (1 << 16,),
                       dtype=torch.int32)
    got = ep.module()(codes)
    want = decode_float(codes, fmt)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int(torch.isnan(want).sum()) == 2 * 1023


def test_half_decode_traces_functionally_bit_for_bit():
    """The donation pass's one-trace functionalization (``make_fx``) takes
    AF16's decode branchless too, with the eager decode's bits."""
    codes = torch.arange(1 << 16, dtype=torch.int32)
    fmt = FLOAT_FORMATS[16]
    with FakeTensorMode():
        fake = torch.zeros(1 << 16, dtype=torch.int32)
    gm = functional_graph(lambda c: decode_float(c, fmt), (fake,))
    got = gm(codes)
    want = decode_float(codes, fmt)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------- plan soundness

def test_broken_fixture_matches_reference(cfg, params, ref_params):
    got = lint_plan(cfg, CompressionPlan.load(FIXTURE), params=params,
                    max_seq_len=64)
    want = ref_lint_plan(ref_get_config("qwen3_8b").reduced(),
                         RefPlan.load(FIXTURE), params=ref_params,
                         max_seq_len=64)
    assert _triples(got) == _triples(want)
    errs = {f.path for f in got if f.severity == "error"}
    assert errs == {"inputs/tokens", "embed", "kv/layer_0", "kv/layer_99"}
    assert any("silent clipping" in f.message for f in got
               if f.path == "inputs/tokens")


def test_plan_soundness_kv_overflow(cfg, params):
    plan = CompressionPlan(float_bits={}, int_bits={},
                           kv_bits={"kv/layer_0": 8})
    findings = lint_plan(cfg, plan, params=params, max_seq_len=64,
                         kv_bounds={"kv/layer_0": 1000.0})
    assert any(f.severity == "error" and "KV overflow" in f.message
               for f in findings)


def test_plan_soundness_clean_default(cfg, params):
    plan = uniform_plan(params, cfg.resolved_weight_bits)
    findings = lint_plan(cfg, plan, params=params, max_seq_len=64)
    assert [f.severity for f in findings] == ["info"]


# ---------------------------------------------------------------- dispatch

def test_dispatch_runs_every_entry_point(cfg, params):
    findings, traced = lint_dispatch(cfg, params=params, device="cpu")
    assert set(traced) == ENTRY_POINTS
    assert [f.severity for f in findings] == ["info"]
    assert findings[0].detail == {"traced": traced}


def _fallbacks(findings):
    return [f for f in findings
            if f.severity == "error" and "fell off the fused path"
            in f.message]


def test_seeded_fallback_matches_reference(cfg, params, ref_params):
    got, _ = lint_dispatch(cfg, params=params, device="cpu",
                           extra_trace=lambda: _inject_fallback(cfg, params))
    ref_cfg = ref_get_config("qwen3_8b").reduced()
    with mock.patch("repro.analysis.dispatch.trace_entry_points",
                    lambda *a, **k: ([], [])), \
            mock.patch("repro.analysis.dispatch.repack", ref_repack_once), \
            mock.patch("repro.analysis.lint.repack", ref_repack_once):
        want, _ = ref_lint_dispatch(
            ref_cfg, params=ref_params,
            extra_trace=lambda: ref_inject_fallback(ref_cfg, ref_params))
    (g,), (w,) = _fallbacks(got), _fallbacks(want)
    for key in ("op", "spec", "shape", "bits", "reason", "candidates"):
        assert g.detail[key] == w.detail[key], key
    assert g.path == w.path and g.detail["candidates"]


def test_card_refusal_is_the_fallback_error(cfg, params):
    """On the card ``linear`` refuses the seeded operand instead of
    recording it; the window records the refusal, so the lint gives the
    same error finding, not an exception."""
    w = pack_tensor(params["blocks"]["attn"]["wk"][0],
                    cfg.resolved_weight_bits)
    card = types.SimpleNamespace(is_cuda=True)
    before = dict(ops.FALLBACK_RECORDS)
    with pytest.raises(FusedPathRefused) as e:
        L._record_unfused("linear", "...b, ab -> ...a", w, card)
    assert isinstance(e.value, NotImplementedError)
    assert "no kernel path" in str(e.value)
    assert dict(ops.FALLBACK_RECORDS) == before      # refused, not recorded
    assert (e.value.op, e.value.spec, e.value.shape, e.value.bits,
            e.value.reason) == ("linear", "...b,ab->...a",
                                tuple(w.logical_shape), w.bits,
                                "unrecognized_spec")

    def refuse():
        raise e.value

    got, traced = lint_dispatch(cfg, params=params, device="cpu",
                                extra_trace=refuse)
    want, _ = lint_dispatch(cfg, params=params, device="cpu",
                            extra_trace=lambda: _inject_fallback(cfg, params))
    assert set(traced) == ENTRY_POINTS
    (g,), (f,) = _fallbacks(got), _fallbacks(want)
    assert g.detail == f.detail and g.path == f.path
    with mock.patch("repro_torch.models.lm.LM.verify_step",
                    side_effect=e.value):
        got, traced = lint_dispatch(cfg, params=params, device="cpu")
    assert "verify_step" not in traced
    assert _fallbacks(got)[0].detail == f.detail


def test_wholesale_decode_of_a_planned_matrix_is_an_error(cfg, params):
    w = pack_tensor(params["blocks"]["attn"]["wq"][0],
                    cfg.resolved_weight_bits)
    n = w.logical_shape[-1]
    findings, _ = lint_dispatch(
        cfg, params=params, device="cpu",
        extra_trace=lambda: ops.unpack(w.data, w.bits, n))
    errs = [f for f in findings if f.severity == "error"]
    assert len(errs) == 1 and "decoded wholesale" in errs[0].message
    assert "blocks/attn/wq" in errs[0].detail["candidates"]


def test_records_before_the_window_still_prove(cfg, params):
    """The port keeps each distinct record once: a second lint in the
    same process (its records all seen before) still proves every leaf,
    and the records from before the window are kept."""
    sentinel = ops.DispatchRecord("sentinel", "test")
    ops.DISPATCH_RECORDS[sentinel] = None
    first, _ = lint_dispatch(cfg, params=params, device="cpu")
    n = len(ops.DISPATCH_RECORDS)
    second, _ = lint_dispatch(cfg, params=params, device="cpu")
    assert [f.severity for f in first] == [f.severity for f in second] \
        == ["info"]
    assert sentinel in ops.DISPATCH_RECORDS
    assert len(ops.DISPATCH_RECORDS) == n
    del ops.DISPATCH_RECORDS[sentinel]


# ------------------------------------------------------------------ sharding

def _zoo_leaves(arch):
    """(path, shape) of every leaf the uniform plan packs, in the zoo
    config's reduced tree, from ``jax.eval_shape`` (nothing allocated)."""
    from repro.core.compress import path_str as ref_path_str
    rcfg = ref_get_config(arch).reduced()
    tree = jax.eval_shape(lambda: RefLM(rcfg).init(prng_key(0)))
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if jnp.issubdtype(leaf.dtype, jnp.floating) and leaf.ndim >= 2:
            out.append((ref_path_str(path), tuple(leaf.shape)))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_rules_match_reference(arch):
    """``spec_for`` / ``spec_for_packed`` against the reference's, as
    tuples, outside a mesh at TP 2, 4, 8 (the lint's ``axis_sizes``) and
    inside an abstract ("data", "model") mesh, TP and ZeRO."""
    leaves = _zoo_leaves(arch)
    assert leaves
    for path, shape in leaves:
        assert sharding.spec_for(path, shape) == tuple(
            ref_sharding.spec_for(path, shape))
        for tp in (2, 4, 8):
            sizes = {"model": tp, "data": 1}
            assert sharding.spec_for_packed(path, shape, axis_sizes=sizes) \
                == tuple(ref_sharding.spec_for_packed(path, shape,
                                                      axis_sizes=sizes))
            mesh = {"data": 2, "model": tp}
            with jax.sharding.use_abstract_mesh(jax.sharding.AbstractMesh(
                    tuple(mesh.values()), tuple(mesh))):
                for mode in ("tp", "zero"):
                    assert sharding.spec_for(path, shape, mode, mesh) \
                        == tuple(ref_sharding.spec_for(path, shape, mode))
                    assert sharding.spec_for_packed(
                        path, shape, mode, mesh=mesh) == tuple(
                            ref_sharding.spec_for_packed(path, shape, mode))


def test_group_of_32_rule():
    mesh = {"data": 1, "model": 2}
    assert sharding.spec_for_packed("blocks/attn/wq", (2, 128, 128),
                                    mesh=mesh) == (None, None, "model")
    # 96 codes split 2 ways is 1.5 groups a shard: the axis replicates
    assert sharding.spec_for_packed("blocks/attn/wq", (2, 128, 96),
                                    mesh=mesh) == (None, None, None)
    assert sharding.spec_for("blocks/attn/wq", (2, 128, 96), mesh=mesh) \
        == (None, None, "model")
    multi = {"pod": 2, "data": 2, "model": 1}
    assert sharding.spec_for("embed", (512, 128), "zero", multi) \
        == ("model", ("pod", "data"))
    assert sharding.spec_for("embed", (512, 128)) == (None, None)


# ------------------------------------------------------------------ donation

def test_decode_step_has_no_donation_hazard(cfg):
    (f,) = lint_donation(cfg)
    assert f.severity == "info" and "3 donated state leaves" in f.message


def _functional(fn, *shapes):
    with FakeTensorMode():
        args = tuple(torch.zeros(s) for s in shapes)
    gm = functional_graph(fn, args)
    buf = next(n for n in gm.graph.nodes if n.op == "placeholder")
    return gm.graph, {buf: "state/buf"}


def test_donation_hazard_detected():
    """A hand-built read of the state after an overwrite is flagged."""
    def f(buf, upd):
        b2 = torch.slice_scatter(buf, upd, 0, 0, 1)
        return b2 + buf[0]                   # reads buf after overwrite

    hazards = donation_hazards(*_functional(f, (4,), (1,)))
    assert "state/buf" in hazards
    w_idx, r_idx, _ = hazards["state/buf"]
    assert w_idx < r_idx


def test_in_place_write_without_a_stale_read_is_clean():
    def f(buf, upd):
        buf[0:1] = upd                       # in place: a mutated input
        return buf * 2.0                     # reads the new value

    def g(buf, upd):
        return torch.slice_scatter(buf, upd, 0, 0, 1)

    assert donation_hazards(*_functional(f, (4,), (1,))) == {}
    assert donation_hazards(*_functional(g, (4,), (1,))) == {}


def test_layer_by_layer_in_place_writes_are_clean():
    """A stacked state written in place one layer at a time, each layer's
    view taken after the last write (as ``decode_step`` does): the
    functional graph reads each view from the new value, no hazard."""
    def f(buf, upd):
        for i in range(3):
            buf[i].add_(upd)
        return buf[2] * 2.0

    assert donation_hazards(*_functional(f, (3, 4), (4,))) == {}


# -------------------------------------------------------- report and CLI

def test_reports_validate_under_both_validators(report, ref_report,
                                                tmp_path):
    for name, rep in (("port", report), ("ref", ref_report)):
        path = str(tmp_path / f"{name}.json")
        rep.save(path)
        assert validate_lint_report(path) == ref_validate_lint(path)
        assert validate_lint_report(path) == (
            {"findings": 5, "errors": 0, "warnings": 0, "infos": 5}, [])
        assert validate_cli.main(["--lint", path]) == 0
    assert set(report.to_jsonable()) == set(ref_report.to_jsonable())


def test_report_schema_roundtrip(tmp_path):
    rep = LintReport(arch="x", passes=["dispatch"])
    rep.extend([Finding(check="dispatch", severity="info", message="ok"),
                Finding(check="dispatch", severity="error", message="bad",
                        path="embed")])
    p = str(tmp_path / "report.json")
    rep.save(p)
    counts, errors = validate_lint_report(p)
    assert errors == [] and (counts, errors) == ref_validate_lint(p)
    assert counts == {"findings": 2, "errors": 1, "warnings": 0, "infos": 1}
    obj = json.load(open(p))
    assert obj["clean"] is False
    assert obj["counters"] == {"dispatch/info": 1, "dispatch/error": 1}


def test_lint_cli_exits_1_on_an_inconsistent_report(tmp_path):
    rep = LintReport(arch="x", passes=["dispatch"])
    rep.extend([Finding(check="dispatch", severity="error", message="b")])
    obj = rep.to_jsonable()
    obj["clean"] = True                      # lie about the verdict
    p = str(tmp_path / "bad.json")
    json.dump(obj, open(p, "w"))
    _, errors = validate_lint_report(p)
    assert any("clean=True" in e for e in errors)
    assert validate_cli.main(["--lint", p]) == 1


def test_report_mirrors_obs_counters():
    counter = obs.REGISTRY.counter(
        "lint_findings_total",
        "Static-analysis lint findings by check and severity.")
    before = counter.value(check="dispatch", severity="error")
    rep = LintReport(arch="x")
    rep.extend([Finding(check="dispatch", severity="error", message="b")])
    rep.mirror_to_obs()
    assert counter.value(check="dispatch", severity="error") == before + 1


def test_finding_rejects_unknown_severity():
    with pytest.raises(ValueError):
        Finding(check="x", severity="fatal", message="no such level")


# the reference CLI's error findings (check, path) on reduced qwen3_8b
_CLI_ERRORS = {
    "clean": [],
    "broken_plan": [("plan_soundness", p) for p in (
        "embed", "inputs/tokens", "kv/layer_0", "kv/layer_99")],
    "inject_fallback": [("dispatch", "blocks/attn/wk;blocks/attn/wv")],
}


@pytest.mark.parametrize("leg, extra", [
    ("clean", ()), ("broken_plan", ("--plan", FIXTURE)),
    ("inject_fallback", ("--inject-fallback",))])
def test_cli_exit_codes(leg, extra, tmp_path):
    """0, 1 and 1, each with the reference CLI's error findings."""
    out = str(tmp_path / "report.json")
    rc = lint_module.main(["--arch", "qwen3_8b", "--device", "cpu",
                           "--out", out, *extra])
    assert rc == (1 if _CLI_ERRORS[leg] else 0)
    assert validate_lint_report(out)[1] == []
    errs = sorted((f["check"], f["path"]) for f in json.load(open(out))
                  ["findings"] if f["severity"] == "error")
    assert errs == _CLI_ERRORS[leg]


def test_emitted_kv_plan_is_the_reference_clis(ref_report, tmp_path):
    got, want = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    assert lint_module.main(["--arch", "qwen3_8b", "--device", "cpu",
                             "--emit-kv-plan", got]) == 0
    with mock.patch.object(ref_lint_module, "run_lint",
                           lambda *a, **k: ref_report):
        assert ref_lint_module.main(["--arch", "qwen3_8b",
                                     "--emit-kv-plan", want]) == 0
    assert open(got, "rb").read() == open(want, "rb").read()


# ------------------------------------------------ the inferred plan, served

def test_inferred_kv_plan_serves_identical_tokens(cfg, params, report):
    """The inferred per-layer KV widths load through
    ``ServeEngine(plan=)``; at the config's width the program is the
    constant-width one, so the greedy tokens are identical."""
    plan = CompressionPlan(float_bits={}, int_bits={},
                           kv_bits=dict(report.kv_bits))
    assert all(b == cfg.resolved_kv_bits for b in plan.kv_bits.values())
    prompts = [[3, 5, 7], [11, 13], [17, 19, 23, 29]]
    outs = []
    for p in (None, plan):
        eng = ServeEngine(cfg, max_seq_len=32, max_slots=2, device="cpu",
                          params=dict(params), plan=p)
        rids = [eng.submit(q, max_new_tokens=4) for q in prompts]
        eng.run_until_drained()
        outs.append([eng.result(r) for r in rids])
    assert outs[0] == outs[1] and all(len(o) == 4 for o in outs[0])


def test_kv_widths_follow_the_bound(cfg, params):
    """A norm scale large enough to push V's bound past AF16's
    max_finite widens the layer's width (a warning, not an error)."""
    from repro_torch.analysis.activations import infer_kv_widths
    big = dict(params, blocks=dict(params["blocks"], attn=dict(
        params["blocks"]["attn"],
        ln=params["blocks"]["attn"]["ln"] + 200.0)))
    bits, bounds, findings = infer_kv_widths(cfg, params=big)
    for key, b in bounds.items():
        assert b > FLOAT_FORMATS[16].max_finite
        assert bits[key] == width_for_bound(b, 16) > 16
    warns = [f for f in findings if f.severity == "warning"]
    assert [f.path for f in warns] == sorted(bits)
    assert all(f"widens to AF{bits[f.path]}" in f.message for f in warns)
