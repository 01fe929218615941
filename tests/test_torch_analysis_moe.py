"""The port's static-analysis gate against the reference's, on the CPU,
for reduced deepseek_moe_16b (the expert banks) and a recurrent family
(reduced falcon_mamba_7b).

  * deepseek_moe_16b: the reports (``run_lint`` of each package over the
    reference's parameters): the same ``clean``, ``passes``,
    ``counters``, ``kv_bits``, ``kv_bounds`` within 1e-12 relative and
    (check, severity, path) multiset; the banks' fused proofs come from
    ``packed_matmul_batched`` records; a seeded wholesale decode of an
    expert bank is an error;
  * falcon_mamba_7b: the dispatch pass runs the reference's entry points
    (no paged decode: the family cannot roll its state back) with the
    reference's findings, its stacked conv and SSM diagonals decode by
    design without an error, and the activation pass keeps the uniform
    width (outside the per-layer KV domain);
  * the donation pass over both families' ``decode_step``.
"""
from __future__ import annotations

import collections
from unittest import mock

import pytest

from repro.analysis.activations import infer_kv_widths as ref_infer_kv_widths
from repro.analysis.dispatch import lint_dispatch as ref_lint_dispatch
from repro.compat import prng_key
from repro.configs import get_config as ref_get_config
from repro.models.lm import LM as RefLM

from repro_torch.analysis.activations import infer_kv_widths
from repro_torch.analysis.dispatch import lint_dispatch
from repro_torch.analysis.lint import run_lint
from repro_torch.analysis.sharding_lint import lint_donation
from repro_torch.configs import get_config
from repro_torch.core.tensor_store import pack_tensor
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from test_torch_analysis import (assert_reports_agree, ref_lint,
                                 ref_repack_once)
from test_torch_serve import _numpy_tree, one_torch_thread  # noqa: F401


def _port_params(ref_params):
    return params_from_numpy(_numpy_tree(ref_params), device="cpu")


@pytest.fixture(scope="module")
def moe():
    ref_params = RefLM(ref_get_config("deepseek_moe_16b").reduced()).init(
        prng_key(0))
    cfg = get_config("deepseek_moe_16b").reduced()
    params = _port_params(ref_params)
    return {"cfg": cfg, "params": params,
            "report": run_lint(cfg, "deepseek_moe_16b", device="cpu",
                               params=params),
            "ref_report": ref_lint("deepseek_moe_16b")}


@pytest.fixture(scope="module")
def mamba():
    ref_cfg = ref_get_config("falcon_mamba_7b").reduced()
    ref_params = RefLM(ref_cfg).init(prng_key(0))
    return {"cfg": get_config("falcon_mamba_7b").reduced(),
            "params": _port_params(ref_params), "ref_cfg": ref_cfg,
            "ref_params": ref_params}


def test_moe_report_matches_reference(moe):
    assert_reports_agree(moe["report"], moe["ref_report"])
    assert moe["report"].clean
    assert set(moe["report"].kv_bits.values()) == {16}


def test_moe_banks_proven_by_the_batched_kernel(moe):
    cfg, params = moe["cfg"], moe["params"]
    ops.DISPATCH_RECORDS.clear()
    findings, traced = lint_dispatch(cfg, params=params, device="cpu")
    assert [f.severity for f in findings] == ["info"]
    banks = {r.shape for r in ops.DISPATCH_RECORDS
             if r.op == "packed_matmul_batched"}
    bank = params["blocks"]["moe"]["experts"]["w_in"]
    w = pack_tensor(bank[0], cfg.resolved_weight_bits)
    assert tuple(w.data.shape) in banks
    # a bank decoded whole instead of streamed is a wholesale decode
    n = w.logical_shape[-1]
    findings, _ = lint_dispatch(
        cfg, params=params, device="cpu",
        extra_trace=lambda: ops.unpack(w.data, w.bits, n))
    errs = [f for f in findings if f.severity == "error"]
    assert len(errs) == 1 and "decoded wholesale" in errs[0].message
    assert {"blocks/moe/experts/w_in", "blocks/moe/experts/w_gate"} <= set(
        errs[0].detail["candidates"])


def test_recurrent_family_dispatch_matches_reference(mamba):
    got, traced = lint_dispatch(mamba["cfg"], params=mamba["params"],
                                device="cpu")
    with mock.patch("repro.analysis.dispatch.repack", ref_repack_once):
        want, ref_traced = ref_lint_dispatch(mamba["ref_cfg"],
                                             params=mamba["ref_params"])
    assert traced == ref_traced == ["decode_step", "prefill_step",
                                    "verify_step", "train_loss"]

    def triples(fs):
        return collections.Counter((f.check, f.severity, f.path) for f in fs)

    assert triples(got) == triples(want) == {("dispatch", "info", ""): 1}


def test_recurrent_diagonals_decode_by_design(mamba):
    """The stacked conv and SSM diagonals (``blocks.PLAIN_LEAVES``) decode
    once per tree as rank-2 layer slices through ``unpack_maybe``:
    recorded, and not an error (the reference's rule reads ``unpack``
    records, which no model path leaves)."""
    cfg, params = mamba["cfg"], mamba["params"]
    ops.DISPATCH_RECORDS.clear()
    findings, _ = lint_dispatch(cfg, params=params, device="cpu")
    decoded = {r.shape for r in ops.DISPATCH_RECORDS
               if r.op == "unpack_maybe" and len(r.shape) == 2}
    conv = params["blocks"]["mamba"]["conv_w"]
    assert tuple(conv.shape[1:]) in decoded
    assert [f.severity for f in findings] == ["info"]


def test_recurrent_family_keeps_the_uniform_kv_width(mamba):
    bits, bounds, findings = infer_kv_widths(mamba["cfg"],
                                             params=mamba["params"])
    ref_bits, ref_bounds, ref_findings = ref_infer_kv_widths(
        mamba["ref_cfg"], params=mamba["ref_params"])
    assert (bits, bounds) == (ref_bits, ref_bounds) == ({}, {})
    assert [(f.severity, f.message) for f in findings] == [
        (f.severity, f.message) for f in ref_findings]


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "falcon_mamba_7b"])
def test_decode_step_has_no_donation_hazard(arch):
    (f,) = lint_donation(get_config(arch).reduced())
    assert f.severity == "info" and "3 donated state leaves" in f.message
