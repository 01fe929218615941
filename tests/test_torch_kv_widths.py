"""Per-layer KV widths in the port against the JAX reference, on the CPU.

Reduced qwen3_8b with ``kv_layer_bits = (16, 8)``: the width-segmented
layout (one ``{"k", "v"}`` buffer per equal-width run of layers), dense
and paged. The port's ``decode_step`` is replayed against the
reference's jitted ``LM.decode_step`` from the same state: cache words
equal bit for bit in every segment, logits within 1e-4 (f32; summation
order). Each layer appends and attends once at its own width. A
reference ``ServeEngine`` given a plan with ``kv_bits`` entries
rewrites its config and drains; the port's engine rewrites its config
the same way and gives the same tokens.
"""
from __future__ import annotations

import collections
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.compress import CompressionPlan as RefPlan
from repro.models.lm import LM as RefLM
from repro.serving import ServeEngine as RefEngine
from repro.serving.engine import _pool_copy_page as ref_pool_copy_page

from repro_torch.configs import get_config
from repro_torch.core.compress import CompressionPlan
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models.lm import LM
from repro_torch.serving import ServeEngine, SpeculativeEngine
from repro_torch.serving.engine import _pool_copy_page
from test_torch_serve import _numpy_tree, one_torch_thread  # noqa: F401

WIDTHS = (16, 8)
B, SEQ, PAGE, STEPS = 2, 12, 4, 3
PLAN_JSON = {"version": 1, "float_bits": {}, "int_bits": {},
             "kv_bits": {f"kv/layer_{i}": b for i, b in enumerate(WIDTHS)}}


def _cfg(get):
    cfg = get("qwen3_8b").reduced()
    return dataclasses.replace(cfg, compression=dataclasses.replace(
        cfg.compression, kv_bits=max(WIDTHS), kv_layer_bits=WIDTHS))


def _prompts():
    rng = np.random.default_rng(3)
    return [[int(t) for t in rng.integers(1, 512, n)] for n in (6, 1, 3)]


@pytest.fixture(scope="module")
def ref():
    """A reference engine on the mixed plan, drained; its parameters."""
    eng = RefEngine(ref_get_config("qwen3_8b").reduced(), max_seq_len=SEQ,
                    max_slots=B, prefill_chunk=4, sample_seed=0,
                    plan=RefPlan.from_jsonable(PLAN_JSON))
    rids = [eng.submit(p, max_new_tokens=4) for p in _prompts()]
    eng.run_until_drained()
    return {"engine": eng, "outs": [eng.result(r) for r in rids],
            "params": _numpy_tree(eng.params)}


def _words(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


def _replay(ref, paged: bool):
    """STEPS decode steps from the same state on both sides: (per step
    logits and the kv tuples) for the reference and the port, and the
    port's attention widths per step."""
    rcfg, cfg = _cfg(ref_get_config), _cfg(get_config)
    rlm, lm = RefLM(rcfg), LM(cfg, device="cpu")
    params = params_from_numpy(ref["params"], device="cpu")
    rng = np.random.default_rng(7 + paged)
    lens = np.array([0, 5], np.int32)
    if paged:
        rst = rlm.init_paged_decode_state(B, SEQ, PAGE, 2 * SEQ // PAGE)
        st = lm.init_paged_decode_state(B, SEQ, PAGE, 2 * SEQ // PAGE)
        table = (rng.permutation(2 * SEQ // PAGE) + 1).astype(
            np.int32).reshape(B, SEQ // PAGE)
        rst["table"], st["table"] = jnp.asarray(table), torch.from_numpy(
            table)
    else:
        rst, st = rlm.init_decode_state(B, SEQ), lm.init_decode_state(B, SEQ)
    rst["len"], st["len"] = jnp.asarray(lens), torch.from_numpy(lens)
    step = jax.jit(rlm.decode_step)
    attn = "paged_attention" if paged else "kv_decode"
    real = getattr(ops, attn)
    widths = []

    def counting(*args):
        widths[-1][args[-2]] += 1          # (..., bits, d)
        return real(*args)

    out = []
    with mock.patch.object(ops, attn, counting):
        for _ in range(STEPS):
            toks = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
            rlog, rst = step(ref["engine"].params, rst, jnp.asarray(toks))
            widths.append(collections.Counter())
            log, st = lm.decode_step(params, st, torch.from_numpy(toks))
            out.append((np.asarray(rlog), log.numpy()))
    return out, rst, st, widths


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_matches_reference_per_segment(ref, paged):
    out, rst, st, widths = _replay(ref, paged)
    assert isinstance(st["kv"], tuple) and len(st["kv"]) == len(WIDTHS)
    for (rlog, log) in out:
        np.testing.assert_allclose(log, rlog, rtol=0, atol=1e-4)
    for rseg, seg, bits in zip(rst["kv"], st["kv"], WIDTHS):
        for name in ("k", "v"):
            assert seg[name].shape[-1] == bits          # 32-wide heads
            np.testing.assert_array_equal(seg[name].numpy(),
                                          _words(rseg[name]))
    np.testing.assert_array_equal(st["len"].numpy(), np.asarray(rst["len"]))
    # one attention launch a layer a step, at that layer's width
    assert widths == [collections.Counter({16: 1, 8: 1})] * STEPS


def test_engine_rewrites_config_and_matches_reference(ref):
    plan = CompressionPlan.from_jsonable(PLAN_JSON)
    params = params_from_numpy(ref["params"], device="cpu")
    outs = {}
    for paged in (False, True):
        eng = ServeEngine(get_config("qwen3_8b").reduced(), max_seq_len=SEQ,
                          max_slots=B, prefill_chunk=4, plan=plan,
                          params=params, device="cpu", paged=paged,
                          kv_page_size=PAGE)
        assert dataclasses.asdict(eng.cfg) == dataclasses.asdict(
            ref["engine"].cfg)
        assert eng.cfg.compression.kv_layer_bits == WIDTHS
        rids = [eng.submit(p, max_new_tokens=4) for p in _prompts()]
        eng.run_until_drained()
        outs[paged] = [eng.result(r) for r in rids]
    assert outs[False] == outs[True] == ref["outs"]
    # uniform widths collapse to the scalar knob
    uni = CompressionPlan(float_bits={}, int_bits={},
                          kv_bits={"kv/layer_0": 8, "kv/layer_1": 8})
    eng = ServeEngine(get_config("qwen3_8b").reduced(), max_slots=1,
                      plan=uni, device="cpu")
    assert (eng.cfg.compression.kv_bits,
            eng.cfg.compression.kv_layer_bits) == (8, None)
    assert isinstance(eng.state["kv"], dict)


def test_speculative_draft_steps_each_layer_down(ref):
    """A mixed-width target's draft cache: each layer one rung below its
    own width (AF8 floors), the scalar at their max; greedy tokens stay
    the plain engine's."""
    plan = CompressionPlan.from_jsonable(PLAN_JSON)
    eng = SpeculativeEngine(get_config("qwen3_8b").reduced(),
                            max_seq_len=SEQ + 2, max_slots=B,
                            prefill_chunk=4, plan=plan, k=2, device="cpu",
                            params=params_from_numpy(ref["params"], "cpu"))
    assert eng.draft_cfg.compression.kv_layer_bits == (12, 8)
    assert eng.draft_kv_bits == 12
    assert [seg["k"].shape[-1] for seg in eng.draft_state["kv"]] == [12, 8]
    rids = [eng.submit(p, max_new_tokens=4) for p in _prompts()]
    eng.run_until_drained()
    assert [eng.result(r) for r in rids] == ref["outs"]


def test_pool_copy_page_covers_segments():
    rng = np.random.default_rng(2)
    kv = tuple({n: rng.integers(-2**31, 2**31 - 1, (1, 4, PAGE, 1, w),
                                dtype=np.int64).astype(np.int32)
                for n in ("k", "v")} for w in WIDTHS)
    want = ref_pool_copy_page(
        tuple({n: jnp.asarray(seg[n]) for n in seg} for seg in kv), 1, 3)
    ours = tuple({n: torch.from_numpy(seg[n].copy()) for n in seg}
                 for seg in kv)
    _pool_copy_page(ours, 1, 3)
    for a, b in zip(ours, want):
        for n in ("k", "v"):
            np.testing.assert_array_equal(a[n].numpy(), np.asarray(b[n]))


@pytest.mark.parametrize("klb,kv_bits,match", [
    ((16,), 16, "entries"), ((16, 8), 12, "max"), ((16, 8), None, "requires")])
def test_bad_layer_widths_raise(klb, kv_bits, match):
    cfg = get_config("qwen3_8b").reduced()
    cfg = dataclasses.replace(cfg, compression=dataclasses.replace(
        cfg.compression, kv_bits=kv_bits, kv_layer_bits=klb))
    with pytest.raises(ValueError, match=match):
        LM(cfg, device="cpu").init_decode_state(1, 8)
