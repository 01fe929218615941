"""The port's integer range analysis against the JAX reference, on the CPU.

``repro_torch.core.range_analysis.analyze`` exports a torch function to
an ATen graph and propagates intervals over it; the reference traces a
jaxpr. Each function of the reference's own range-analysis tests
(``tests/test_static_analysis.py``), written once in JAX and once in
torch, must give the same output intervals and bits, as must the
structured control flow (a while loop, a scan, a cond) and single ops
over random input intervals. Every interval must also hold the values
the function computes. ``input_specs`` and ``derive_int_bits`` must
give the reference's dicts for all six families.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import get_config as ref_get_config
from repro.core.calibrate import derive_int_bits as ref_derive_int_bits
from repro.core.range_analysis import Interval as RefInterval
from repro.core.range_analysis import analyze as ref_analyze
from repro.core.range_analysis import input_specs as ref_input_specs

from repro_torch.configs import get_config
from repro_torch.core.calibrate import derive_int_bits
from repro_torch.core.range_analysis import Interval, analyze, input_specs

FAMILY_ARCHS = ("qwen3_8b", "deepseek_moe_16b", "paligemma_3b",
                "whisper_small", "falcon_mamba_7b", "recurrentgemma_9b")


def _bounds(itv):
    return (float(itv.lo), float(itv.hi))


def _both(jax_fn, torch_fn, shapes, ranges, dtypes=None):
    """Output intervals of both analyses over zero example arguments of
    ``shapes`` (int32 unless ``dtypes`` says float32)."""
    dtypes = dtypes or ["int32"] * len(shapes)
    jargs = [jnp.zeros(s, getattr(jnp, d)) for s, d in zip(shapes, dtypes)]
    targs = [torch.zeros(s, dtype=getattr(torch, d))
             for s, d in zip(shapes, dtypes)]
    ref = ref_analyze(jax_fn, *jargs, input_ranges=[
        None if r is None else RefInterval(*r) for r in ranges])
    got = analyze(torch_fn, *targs, input_ranges=[
        None if r is None else Interval(*r) for r in ranges])
    return ref.out_intervals, got.out_intervals


def _same(ref_itvs, got_itvs):
    assert [_bounds(i) for i in got_itvs] == [_bounds(i) for i in ref_itvs]
    assert [i.bits() for i in got_itvs] == [i.bits() for i in ref_itvs]


# -- the reference's own test functions ---------------------------------------

def _jax_loop(x):
    def body(c, _):
        return jnp.minimum(c + 1, 10), c
    c, _ = jax.lax.scan(body, jnp.int32(0), None, length=100)
    return c


def _torch_loop(x):
    from torch._higher_order_ops.scan import scan

    def body(c, _):
        return torch.clamp(c + 1, max=10), c.clone()
    c, _ = scan(body, torch.zeros((), dtype=torch.int32),
                torch.zeros(100, dtype=torch.int32))
    return c


CASES = {
    "basic_arith": (lambda t: (t + 2) * 3 - 1, lambda t: (t + 2) * 3 - 1,
                    [(8,)], [(0, 9)], None, (5, 32)),
    "iota_mod_minimum": (
        lambda t: jnp.minimum(t % 64, jnp.arange(t.shape[-1])),
        lambda t: torch.minimum(t % 64, torch.arange(t.shape[-1])),
        [(128,)], [(0, 100000)], None, (0, 127)),
    "router_topk": (lambda x: jax.lax.top_k(x, 6)[1],
                    lambda x: torch.topk(x, 6).indices,
                    [(4, 64)], [None], ["float32"], (0, 63)),
    "scan_fixpoint": (_jax_loop, _torch_loop, [()], [None], None, (0, 10)),
    "unbounded_is_sound": (lambda x: x * x, lambda x: x * x, [(4,)], [None],
                           None, (-np.inf, np.inf)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_reference_functions_same_intervals(name):
    jax_fn, torch_fn, shapes, ranges, dtypes, want = CASES[name]
    ref, got = _both(jax_fn, torch_fn, shapes, ranges, dtypes)
    _same(ref, got)
    assert _bounds(got[0]) == tuple(float(v) for v in want)


def test_while_loop_and_cond_same_intervals():
    from torch._higher_order_ops.while_loop import while_loop

    def jax_while(i, c):
        return jax.lax.while_loop(
            lambda s: s[0] < 100,
            lambda s: (s[0] + 1, jnp.minimum(s[1] + 2, 50)), (i, c))

    def torch_while(i, c):
        return while_loop(lambda i, c: i < 100,
                          lambda i, c: (i + 1, torch.clamp(c + 2, max=50)),
                          (i, c))

    _same(*_both(jax_while, torch_while, [(), ()], [(0, 0), (0, 0)]))

    def jax_cond(p, x):
        return jax.lax.cond(p.sum() > 0, lambda x: x + 1, lambda x: x * 2, x)

    def torch_cond(p, x):
        return torch.cond(p.sum() > 0, lambda x: x + 1, lambda x: x * 2,
                          (x,))

    ref, got = _both(jax_cond, torch_cond, [(1,), (1,)], [None, (0, 5)])
    _same(ref, got)
    assert _bounds(got[0]) == (0.0, 10.0)


# -- single ops over random intervals -----------------------------------------

OPS = {
    "add": (lambda a, b: a + b, lambda a, b: a + b),
    "sub": (lambda a, b: a - b, lambda a, b: a - b),
    "mul": (lambda a, b: a * b, lambda a, b: a * b),
    "max": (jnp.maximum, torch.maximum),
    "min": (jnp.minimum, torch.minimum),
    "neg": (lambda a, b: -a, lambda a, b: -a),
    "abs": (lambda a, b: jnp.abs(a), lambda a, b: torch.abs(a)),
    "shift_left": (lambda a, b: jnp.left_shift(a, 3),
                   lambda a, b: a << 3),
    "concatenate": (lambda a, b: jnp.concatenate([a, b]),
                    lambda a, b: torch.cat([a, b])),
    "select": (lambda a, b: jnp.where(a > b, a, b),
               lambda a, b: torch.where(a > b, a, b)),
    "reduce_sum": (lambda a, b: jnp.sum(a), lambda a, b: torch.sum(a)),
    "convert_int16": (lambda a, b: a.astype(jnp.int16),
                      lambda a, b: a.to(torch.int16)),
    "argmax": (lambda a, b: jnp.argmax(a), lambda a, b: torch.argmax(a)),
}


@pytest.mark.parametrize("op", list(OPS))
@settings(max_examples=6, deadline=None, database=None)
@given(st.integers(-300, 300), st.integers(0, 300),
       st.integers(-300, 300), st.integers(0, 300), st.integers(0, 2**31))
def test_single_op_same_intervals_and_sound(op, a_lo, a_w, b_lo, b_w, seed):
    jax_fn, torch_fn = OPS[op]
    ranges = [(a_lo, a_lo + a_w), (b_lo, b_lo + b_w)]
    ref, got = _both(jax_fn, torch_fn, [(5,), (5,)], ranges)
    _same(ref, got)
    rng = np.random.default_rng(seed)
    a, b = (torch.from_numpy(rng.integers(lo, hi + 1, 5).astype(np.int32))
            for lo, hi in ranges)
    out = torch_fn(a, b)
    assert got[0].lo <= out.min().item() and out.max().item() <= got[0].hi


def test_narrowing_convert_wraps_soundly():
    """A source range past int8's: the values wrap, so the port gives
    int8's whole range (the reference clips to [lo, 127], which the
    wrapped values leave)."""
    rep = analyze(lambda a: a.to(torch.int8), torch.zeros(5, dtype=torch.int32),
                  input_ranges=[Interval(0, 134)])
    assert _bounds(rep.out_intervals[0]) == (-128.0, 127.0)
    assert torch.tensor([134], dtype=torch.int32).to(torch.int8).item() < 0
    inside = analyze(lambda a: a.to(torch.int8),
                     torch.zeros(5, dtype=torch.int32),
                     input_ranges=[Interval(-7, 100)])
    assert _bounds(inside.out_intervals[0]) == (-7.0, 100.0)


def test_unknown_op_is_top():
    ref, got = _both(jnp.cumsum, lambda t: torch.cumsum(t, 0), [(6,)],
                     [(0, 3)])
    _same(ref, got)
    assert got[0].bits() is None


# -- config-seeded input ranges and derived widths ----------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("max_seq_len", [64, 4096])
def test_input_specs_and_derived_int_bits_match(arch, max_seq_len):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    got = input_specs(cfg, max_seq_len)
    ref = ref_input_specs(ref_cfg, max_seq_len)
    assert {k: _bounds(v) for k, v in got.items()} == {
        k: _bounds(v) for k, v in ref.items()}
    assert derive_int_bits(cfg, max_seq_len) == ref_derive_int_bits(
        ref_cfg, max_seq_len)
    small = dataclasses.replace(cfg, vocab_size=512)
    assert derive_int_bits(small, 64)["inputs/tokens"] == (9, False)
    with pytest.raises(ValueError, match="max_seq_len"):
        input_specs(cfg, 0)
