"""Calibration through the port against the JAX reference, on the CPU.

Each case holds ``repro_torch`` to ``repro`` on the same numpy inputs:

  * the quality metrics (SSIM, %-deviation, loss-delta, binary) within
    1e-6, and the same acceptance decisions;
  * the tensor round trip ``quantize_dequantize`` (``ops.truncate`` then
    ``ops.convert``, their plain versions here) bit for bit at all 7
    widths, on every code's value (AF8-AF16) or a sample of them, the
    round-to-nearest-even ties between them, subnormals, +-0, +-inf and
    NaN;
  * ``tune_tensors`` on a toy function, ``plan_tensors`` and the plan's
    footprint and mean width: the same formats, evaluations and plans;
  * ``calibrate`` of reduced qwen3-8b (f32) from the reference's
    parameters (through ``interop.params_from_numpy``) and its batches:
    the same plan and ``tune_evals``, ``ref_loss`` within 1e-5 relative,
    and ``metric`` and ``uniform_metric`` (differences of two losses)
    within 1e-5 of the loss;
  * a mixed-width plan that cycles the leaves through all seven widths,
    served by the port's engine and the reference's: every leaf at its
    plan width, the same greedy tokens;
  * the launchers: ``--calibrate --save-plan`` writes a plan ``--plan``
    reads back, the exclusions exit as the reference's do, every flag of
    the reference's serve launcher and calibration command exists.

A trial whose metric lies within float error of the gate could go
either way on the two sides: the search's decisions are compared only
after every trial's metric is checked to lie at least GATE_MARGIN from
its threshold, and a test fails loudly otherwise.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import re
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.core.calibrate as ref_calibrate_module
import repro.core.precision_tuning as ref_tuning
import repro.launch.serve as ref_serve_launcher
import repro.serving.engine as ref_engine_module
from repro.compat import prng_key
from repro.configs import get_config as ref_get_config
from repro.core import quality as ref_quality
from repro.core.compress import CompressionPlan as RefPlan
from repro.core.compress import plan_tensors as ref_plan_tensors
from repro.core.compress import uniform_plan as ref_uniform_plan
from repro.core.formats import FLOAT_FORMATS as REF_FORMATS
from repro.core.formats import decode_float as ref_decode_float
from repro.core.range_analysis import Interval as RefInterval
from repro.data import SyntheticTokens as RefTokens
from repro.models.lm import LM as RefLM
from repro.serving import ServeEngine as RefEngine

from repro_torch.configs import get_config
from repro_torch.core import quality
from repro_torch.core.calibrate import calibrate, derive_int_bits, float_leaves
from repro_torch.core.compress import (CompressionPlan, path_str,
                                       plan_tensors, uniform_plan)
from repro_torch.core.formats import FLOAT_LADDER
from repro_torch.core.precision_tuning import quantize_dequantize, tune_tensors
from repro_torch.core.range_analysis import Interval
from repro_torch.core.tensor_store import is_packed, tree_map_with_path
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_launcher
from repro_torch.serving import ServeEngine
from test_torch_serve import (_jitted_repack, _numpy_tree,  # noqa: F401
                              one_torch_thread)

# the calibration commands (``tuning.calibrate`` names the function too)
ref_tuning_cli = importlib.import_module("repro.tuning.calibrate")
tuning_cli = importlib.import_module("repro_torch.tuning.calibrate")

ARCH = "qwen3_8b"
METRIC_TOL = 1e-6               # the quality metrics, port vs reference
LOSS_RTOL = 1e-5                # calibration losses, relative
GATE = 0.05                     # the launcher's default loss_delta gate
# no trial's metric may lie this close to its gate: the port's losses
# sit within 1e-5 relative of the reference's (~7e-5 nats at a loss of
# 6.6), so a loss delta is within ~1.4e-4 nats, and a %-deviation of
# the toy function within ~1e-4 points
GATE_MARGIN = 5e-4
SLOTS, MAX_SEQ, CHUNK, NEW = 2, 24, 4, 4


@dataclasses.dataclass(frozen=True)
class Recording(quality.QualitySpec):
    """A QualitySpec that keeps the metric of every trial it judges."""

    trials: list = dataclasses.field(default_factory=list, compare=False)

    def accepts(self, ref, out) -> bool:
        self.trials.append(self.metric(ref, out))
        return super().accepts(ref, out)


def assert_clear_of_gate(spec: Recording) -> None:
    assert spec.trials, "the search judged no trial"
    margin = min(abs(m - spec.threshold) for m in spec.trials)
    assert margin > GATE_MARGIN, (
        f"a trial's metric lies {margin:.3g} from the gate {spec.threshold} "
        f"(< {GATE_MARGIN}): the two sides may decide it differently")


def _ref_qdq():
    """The reference's round trip, jitted (the same integer program)."""
    return jax.jit(ref_tuning.quantize_dequantize, static_argnums=1)


def _ref_tuning_jitted():
    q = _ref_qdq()
    return (mock.patch.object(ref_calibrate_module, "quantize_dequantize", q),
            mock.patch.object(ref_tuning, "quantize_dequantize", q))


# -- quality metrics ------------------------------------------------------------

@settings(max_examples=4, deadline=None, database=None)
@given(st.integers(0, 2**31), st.sampled_from([(16, 16), (23, 31),
                                               (12, 20, 3)]),
       st.floats(0.0, 0.6))
def test_ssim_matches_reference(seed, shape, noise):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + noise * rng.standard_normal(shape), 0, 1).astype(
        np.float32)
    for x, y in ((a, b), (a, a)):
        got = float(quality.ssim(torch.from_numpy(x), torch.from_numpy(y)))
        want = float(ref_quality.ssim(jnp.asarray(x), jnp.asarray(y)))
        assert abs(got - want) <= METRIC_TOL


@settings(max_examples=5, deadline=None, database=None)
@given(st.integers(0, 2**31), st.integers(1, 64), st.floats(0.0, 0.3))
def test_deviation_loss_delta_binary_match_reference(seed, n, noise):
    rng = np.random.default_rng(seed)
    ref = rng.standard_normal(n).astype(np.float32) * 3
    out = (ref * (1 + noise * rng.standard_normal(n))).astype(np.float32)
    tr, to = torch.from_numpy(ref), torch.from_numpy(out)
    jr, jo = jnp.asarray(ref), jnp.asarray(out)
    assert abs(float(quality.percent_deviation(tr, to)) - float(
        ref_quality.percent_deviation(jr, jo))) <= METRIC_TOL * max(
        1.0, float(ref_quality.percent_deviation(jr, jo)))
    assert abs(quality.loss_delta(tr, to) - ref_quality.loss_delta(
        jr, jo)) <= METRIC_TOL
    for x, y in ((tr, to), (tr, tr.clone())):
        assert quality.binary_correct(x, y) == ref_quality.binary_correct(
            jnp.asarray(x.numpy()), jnp.asarray(y.numpy()))
    specs = [("ssim", 1.0), ("deviation", 0.0), ("deviation", 5.0),
             ("deviation", 10.0), ("loss_delta", 0.05), ("loss_delta", 0.5),
             ("binary", 0.0)]
    for kind, th in specs:
        if kind == "ssim":
            pairs = ((tr[:1].expand(4, 4), to[:1].expand(4, 4)),)
        else:
            pairs = ((tr, to), (tr, tr.clone()))
        for x, y in pairs:
            got = quality.QualitySpec(kind, th)
            want = ref_quality.QualitySpec(kind, th)
            jx, jy = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())
            assert got.accepts(x, y) == want.accepts(jx, jy), (kind, th)
            assert abs(got.metric(x, y) - want.metric(jx, jy)) <= (
                METRIC_TOL * max(1.0, abs(want.metric(jx, jy))))
    assert set(quality.HIGH) == set(ref_quality.HIGH)
    for table, ref_table in ((quality.HIGH, ref_quality.HIGH),
                             (quality.PERFECT, ref_quality.PERFECT)):
        assert {k: (v.kind, v.threshold) for k, v in table.items()} == {
            k: (v.kind, v.threshold) for k, v in ref_table.items()}


# -- the tensor round trip -------------------------------------------------------

def _special_inputs(bits: int) -> np.ndarray:
    """f32 values that exercise a width's rounding: every code's value
    (AF8-AF16; a seeded sample of codes at AF20-AF28), the midpoints of
    neighbouring values (round-to-nearest-even ties), values past the
    largest finite one, f32 subnormals, +-0, +-inf and NaN."""
    fmt = REF_FORMATS[bits]
    rng = np.random.default_rng(bits)
    if bits <= 16:
        codes = np.arange(1 << bits, dtype=np.uint32)
    else:
        codes = rng.integers(0, 1 << bits, 4096, dtype=np.uint32)
    vals = np.asarray(ref_decode_float(jnp.asarray(codes), fmt))
    finite = np.unique(vals[np.isfinite(vals)].astype(np.float64))
    ties = ((finite[1:] + finite[:-1]) / 2).astype(np.float32)
    top = finite.max()
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, top * 1.5,
                         -top * 3, 1e-45, -3e-42, 1.17e-38, 3.4e38,
                         -3.4e38], np.float32)
    noise = (rng.standard_normal(2048) * np.exp2(
        rng.integers(-30, 30, 2048))).astype(np.float32)
    return np.concatenate([vals.astype(np.float32), ties, specials, noise])


@pytest.mark.parametrize("bits", FLOAT_LADDER)
def test_quantize_dequantize_bit_exact(bits):
    x = _special_inputs(bits) if bits < 32 else _special_inputs(28)
    got = quantize_dequantize(torch.from_numpy(x), bits)
    want = np.asarray(_ref_qdq()(jnp.asarray(x), bits))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    # bf16 leaves (the full-width configs) widen exactly first
    xb = torch.from_numpy(x[np.isfinite(x)]).to(torch.bfloat16)
    np.testing.assert_array_equal(
        quantize_dequantize(xb, bits).numpy().view(np.int32),
        quantize_dequantize(xb.float(), bits).numpy().view(np.int32))


# -- the tensor search, plans ----------------------------------------------------

def _toy():
    rng = np.random.default_rng(0)
    w1 = (rng.standard_normal((32, 32)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((32, 8)) * 0.1).astype(np.float32)
    x = rng.standard_normal((8, 32)).astype(np.float32)
    return w1, w2, x


@pytest.mark.parametrize("kind,threshold", [("deviation", 5.0),
                                            ("deviation", 0.5),
                                            ("loss_delta", 0.02)])
def test_tune_tensors_matches_reference(kind, threshold):
    w1, w2, x = _toy()
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)

    def reduce(y):                # loss_delta judges a per-row loss
        return y if kind == "deviation" else (y ** 2).mean(-1)

    def port_apply(ts):
        return reduce(torch.tanh(tx @ ts["w1"]) @ ts["w2"])

    def ref_apply(ts):
        return reduce(jnp.tanh(jx @ ts["w1"]) @ ts["w2"])

    spec = Recording(kind, threshold)
    got = tune_tensors(port_apply, {"w1": torch.from_numpy(w1),
                                    "w2": torch.from_numpy(w2)}, spec)
    with _ref_tuning_jitted()[1]:
        want = ref_tuning.tune_tensors(
            ref_apply, {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)},
            ref_quality.QualitySpec(kind, threshold))
    assert_clear_of_gate(spec)
    assert got.formats == want.formats
    assert got.evaluations == want.evaluations == len(spec.trials)
    assert got.mean_bits() == want.mean_bits()


def test_plan_tensors_footprint_and_mean_width_match_reference():
    w1, w2, x = _toy()
    idx = np.arange(40, dtype=np.int32) % 37
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    spec = Recording("deviation", 5.0)
    got = plan_tensors(
        lambda ts: torch.tanh(tx @ ts["w1"]) @ ts["w2"],
        {"w1": torch.from_numpy(w1), "w2": torch.from_numpy(w2),
         "idx": torch.from_numpy(idx), "pos": torch.from_numpy(idx)},
        spec, int_ranges={"pos": Interval(0, 1000)})
    with _ref_tuning_jitted()[1]:
        want = ref_plan_tensors(
            lambda ts: jnp.tanh(jx @ ts["w1"]) @ ts["w2"],
            {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2),
             "idx": jnp.asarray(idx), "pos": jnp.asarray(idx)},
            ref_quality.QualitySpec("deviation", 5.0),
            int_ranges={"pos": RefInterval(0, 1000)})
    assert_clear_of_gate(spec)
    assert got.to_jsonable() == want.to_jsonable()
    shapes = {"w1": (32, 32), "w2": (32, 8), "idx": (40,), "pos": (40,),
              "other": (3, 5)}
    plan = CompressionPlan(float_bits={"w1": 12, "w2": 20},
                           int_bits={"idx": (6, False)})
    ref_plan = RefPlan.from_jsonable(plan.to_jsonable())
    sizes = {k: int(np.prod(s)) for k, s in shapes.items()}
    assert plan.footprint_ratio({k: torch.zeros(s) for k, s in
                                 shapes.items()}) == ref_plan.footprint_ratio(
        {k: jnp.zeros(s) for k, s in shapes.items()})
    assert plan.mean_float_bits(sizes) == ref_plan.mean_float_bits(sizes)
    assert plan.mean_float_bits() == ref_plan.mean_float_bits()
    assert CompressionPlan({}, {}).mean_float_bits() == 32.0


# -- calibration of a reduced config ---------------------------------------------

@pytest.fixture(scope="module")
def ref_params():
    return RefLM(ref_get_config(ARCH).reduced()).init(prng_key(0))


@pytest.fixture(scope="module")
def calibration(ref_params):
    """The reference's calibration (its jitted round trip) and the
    port's, from the reference's parameters and batches."""
    ref_cfg, cfg = ref_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    data = RefTokens(vocab_size=ref_cfg.vocab_size, seq_len=16,
                     global_batch=2, seed=0)
    extra = ref_calibrate_module._extra_inputs(ref_cfg, 2)
    batches = [data.batch_at(i).as_dict(dict(extra)) for i in range(2)]
    patches = _ref_tuning_jitted()
    with patches[0], patches[1]:
        want = ref_calibrate_module.calibrate(
            ref_cfg, ref_quality.QualitySpec("loss_delta", GATE),
            params=ref_params, max_seq_len=64)
    spec = Recording("loss_delta", GATE)
    ops.reset_launch_counts()
    got = calibrate(
        cfg, spec, params=params_from_numpy(_numpy_tree(ref_params),
                                            device="cpu"),
        batches=[{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
                 for b in batches],
        max_seq_len=64, device="cpu")
    return {"want": want, "got": got, "spec": spec,
            "launches": ops.launch_counts()}


def test_calibrate_plan_matches_reference(calibration):
    got, want = calibration["got"], calibration["want"]
    assert_clear_of_gate(calibration["spec"])
    assert got.plan.to_jsonable() == want.plan.to_jsonable()
    assert got.tune_evals == want.tune_evals == len(
        calibration["spec"].trials)
    assert got.plan.int_bits == derive_int_bits(get_config(ARCH).reduced(),
                                                64)
    assert all(b in FLOAT_LADDER for b in got.plan.float_bits.values())
    # the plain versions ran: no kernel launched on the CPU
    assert not any(calibration["launches"].values())


def test_calibrate_metrics_match_reference(calibration):
    got, want = calibration["got"], calibration["want"]
    assert abs(got.ref_loss - want.ref_loss) <= LOSS_RTOL * want.ref_loss
    for key in ("metric", "uniform_metric"):
        assert abs(getattr(got, key) - getattr(want, key)) <= (
            LOSS_RTOL * want.ref_loss), key
    for key in ("mean_float_bits", "footprint_ratio", "uniform_ratio",
                "uniform_bits", "n_batches", "batch_size", "seq_len",
                "accepted", "beats_uniform"):
        assert getattr(got, key) == getattr(want, key), key


def test_calibrate_summary_keys_match_reference(calibration):
    got, want = calibration["got"].summary(), calibration["want"].summary()
    assert set(got) == set(want)
    json.dumps(got)
    assert got["accepted"] and got["beats_uniform"]


def test_float_leaves_keys_and_order_match_reference(ref_params):
    got = float_leaves(params_from_numpy(_numpy_tree(ref_params),
                                         device="cpu"))
    want = ref_calibrate_module.float_leaves(ref_params)
    assert list(got) == list(want)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}


# -- serving a mixed-width plan ---------------------------------------------------

def _prompts():
    rng = np.random.default_rng(5)
    return [[int(t) for t in rng.integers(1, 512, n)] for n in (5, 9, 1)]


def _drain(eng):
    rids = [eng.submit(p, max_new_tokens=NEW) for p in _prompts()]
    eng.run_until_drained()
    return [eng.result(r) for r in rids]


def test_serve_engine_packs_at_mixed_plan_widths(ref_params):
    """Every leaf of a plan that cycles the leaves through all seven
    widths packed at its width (AF32 leaves stay plain), and the greedy
    tokens the reference engine gives under the same plan."""
    keys = sorted(ref_uniform_plan(ref_params, 16).float_bits)
    widths = {k: FLOAT_LADDER[i % len(FLOAT_LADDER)]
              for i, k in enumerate(keys)}
    plan = CompressionPlan(float_bits=widths, int_bits={})
    ref_cfg = ref_get_config(ARCH).reduced()
    with mock.patch.object(ref_engine_module, "repack", _jitted_repack):
        ref = RefEngine(ref_cfg, max_seq_len=MAX_SEQ, max_slots=SLOTS,
                        prefill_chunk=CHUNK, sample_seed=0,
                        plan=RefPlan.from_jsonable(plan.to_jsonable()))
    want = _drain(ref)
    eng = ServeEngine(get_config(ARCH).reduced(), max_seq_len=MAX_SEQ,
                      max_slots=SLOTS, prefill_chunk=CHUNK, plan=plan,
                      params=params_from_numpy(_numpy_tree(ref_params),
                                               device="cpu"),
                      device="cpu")
    assert eng.weight_plan is plan
    got = {}

    def visit(path, leaf):
        key = path_str(path)
        if key in widths:
            got[key] = leaf.bits if is_packed(leaf) else 32
        return leaf
    tree_map_with_path(visit, eng.params)
    assert got == widths
    assert set(widths.values()) == set(FLOAT_LADDER)
    outs = _drain(eng)
    assert all(o is not None and len(o) == NEW for o in outs)
    assert outs == want


# -- the launchers ----------------------------------------------------------------

def _help_flags(main, argv=None):
    """The --flags a launcher's --help lists (``argv`` None: the
    reference's, which reads sys.argv)."""
    buf = io.StringIO()
    with mock.patch.object(sys, "argv", ["prog", "--help"]), \
            contextlib.redirect_stdout(buf), \
            pytest.raises(SystemExit) as e:
        main() if argv is None else main(argv)
    assert e.value.code == 0
    return set(re.findall(r"--[a-z][a-z-]*", buf.getvalue()))


def test_launchers_have_every_reference_flag():
    for ref_main, port_main in ((ref_serve_launcher.main, serve_launcher.main),
                                (ref_tuning_cli.main, tuning_cli.main)):
        want = _help_flags(ref_main)
        assert "--arch" in want
        assert want <= _help_flags(port_main, ["--help"])


@pytest.mark.parametrize("argv,message", [
    (["--plan", "p.json", "--calibrate"], "--plan and --calibrate are "
     "exclusive"),
    (["--save-plan", "p.json"], "--save-plan needs --plan or --calibrate"),
])
def test_launcher_exclusions_exit_as_the_reference(argv, message):
    with mock.patch.object(sys, "argv", ["serve", "--arch", ARCH] + argv), \
            pytest.raises(SystemExit) as ref_exit:
        ref_serve_launcher.main()
    with pytest.raises(SystemExit) as port_exit:
        serve_launcher.main(["--arch", ARCH, "--reduced", "--device",
                             "cpu"] + argv)
    assert str(port_exit.value.code) == str(ref_exit.value.code) == message


def test_calibrate_save_plan_then_plan_reads_it_back(tmp_path, capsys):
    path = str(tmp_path / "plan.json")
    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--requests",
            "3", "--max-new-tokens", "3", "--max-seq-len", "32"]
    serve_launcher.main(base + ["--calibrate", "--save-plan", path])
    out = capsys.readouterr().out
    assert re.search(r"calibrated qwen3-8b-smoke: mean float bits [\d.]+ "
                     r"\(uniform 16\), loss_delta=[\d.e-]+ \(gate 0.05\)",
                     out), out
    assert f"wrote plan to {path}" in out and "completed 3/3" in out
    plan = CompressionPlan.load(path)
    cfg = get_config(ARCH).reduced()
    assert plan.int_bits == derive_int_bits(cfg, 32)
    assert set(plan.float_bits) <= set(uniform_plan(
        params_from_numpy(_numpy_tree(RefLM(ref_get_config(
            ARCH).reduced()).init(prng_key(0))), device="cpu"),
        16).float_bits)
    serve_launcher.main(base + ["--plan", path])
    out = capsys.readouterr().out
    assert (f"loaded plan {path}: {len(plan.float_bits)} float leaves, "
            f"{len(plan.int_bits)} int streams, 0 KV layers") in out
    assert "completed 3/3" in out


def test_tuning_command_writes_a_plan(tmp_path, capsys, calibration):
    path = str(tmp_path / "plan.json")
    tuning_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--out", path, "--batches", "1", "--seq-len", "8",
                     "--max-seq-len", "64"])
    out = capsys.readouterr().out
    summary = json.loads(out[:out.rindex("}") + 1])
    assert set(summary) == set(calibration["want"].summary())
    assert summary["accepted"] and f"wrote {path}" in out
    plan = CompressionPlan.load(path)
    assert plan.tune_evals == summary["tune_evals"] > 0
    assert plan.int_bits == derive_int_bits(get_config(ARCH).reduced(), 64)
