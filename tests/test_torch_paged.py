"""The port's paged KV serving against the JAX reference, on the CPU.

The page pool, the paged-attention plain version, the pool append and
the paged engine, each held to the reference on the same inputs (made
with numpy from a seed): the pool bit for bit in results, events and
counters; attention within 1e-5 (f32, summation order); appended words
bit for bit; engines with identical greedy tokens and paged counters and
decode logits within 1e-4. The CUDA kernel is held to the plain version
in ``tests/test_torch_kernels_ref.py -k cuda``.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib.util
import types
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.serving.engine as ref_engine_module
from repro.configs import get_config as ref_get_config
from repro.core.allocator import KVPagePool as RefPool
from repro.kernels import ref as jref
from repro.kernels.paged_attention import paged_attention as jax_paged_attention
from repro.models.attention import append_kv_pool_row as ref_append
from repro.obs import snapshot_keys as ref_snapshot_keys
from repro.serving import ServeEngine as RefEngine

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.core.allocator import KVPagePool, PoolExhausted
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import append_kv_pool_row
from repro_torch.models.lm import LM
from repro_torch.serving import ServeEngine
from test_torch_serve import (_jitted_repack, _numpy_tree,  # noqa: F401
                              one_torch_thread)

ROOT = Path(__file__).resolve().parents[1]
# the reference's paged serving bench: its widths and its two traffics
_spec = importlib.util.spec_from_file_location(
    "serving_paged_bench", ROOT / "benchmarks" / "serving_paged.py")
BENCH = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(BENCH)
SEQ, PAGE, SLOTS, NEW = BENCH.SEQ, BENCH.PAGE, BENCH.SLOTS, BENCH.MAX_NEW
# the mixed traffic runs over-committed, on half the dense pool
MIXED_POOL = SLOTS * (SEQ // PAGE) // 2
HKV, D, H = 2, 32, 4


# ---------------------------------------------------------------------------
# the page pool
# ---------------------------------------------------------------------------

_OPS = st.lists(st.tuples(
    st.sampled_from(["alloc", "alloc_reserved", "free", "retain", "reserve",
                     "release", "register", "lookup", "is_registered"]),
    st.integers(0, 9), st.integers(0, 3)), max_size=60)


def _apply(pool, op, a, b):
    """One pool operation; returns (value, error type and message)."""
    key = pool.chain_key(None, [b, a % 3])
    try:
        if op == "alloc":
            return pool.alloc(), None
        if op == "alloc_reserved":
            return pool.alloc(reserved=True), None
        if op == "free":
            return pool.free(a), None
        if op == "retain":
            return pool.retain(a), None
        if op == "reserve":
            return pool.reserve(a - 2), None
        if op == "release":
            return pool.release(a % 4), None
        if op == "register":
            return pool.register(key, a), None
        if op == "lookup":
            return pool.lookup(key), None
        return pool.is_registered(key), None
    except (ValueError, RuntimeError) as e:
        return None, (type(e).__name__, str(e))


def _pool_state(pool):
    return (pool.used, pool.reserved, pool.free_pages, pool.utilization,
            pool.peak_utilization, pool.peak_used, dict(pool.events),
            pool.prefix_hits, pool.prefix_queries, pool.prefix_hit_rate,
            [pool.refcount(p) for p in range(pool.n_pages + 2)],
            [pool.can_reserve(n) for n in range(-1, pool.n_pages + 2)])


@settings(max_examples=60, deadline=None)
@given(n_pages=st.integers(1, 8), ops_=_OPS)
def test_pool_matches_reference(n_pages, ops_):
    """The same operation sequence on both pools: the same results, the
    same errors, events, hooks and counters after every step."""
    ours, theirs = KVPagePool(n_pages, 4), RefPool(n_pages, 4)
    seen = {"ours": [], "theirs": []}
    ours.on_event = lambda name, **kw: seen["ours"].append((name, kw))
    theirs.on_event = lambda name, **kw: seen["theirs"].append((name, kw))
    for op, a, b in ops_:
        got, err = _apply(ours, op, a, b)
        want, ref_err = _apply(theirs, op, a, b)
        assert (got, err) == (want, ref_err), op
        assert _pool_state(ours) == _pool_state(theirs), op
    assert seen["ours"] == seen["theirs"]


def test_pool_errors_name_the_pool():
    pool = KVPagePool(2, 4)
    pool.reserve(2)
    with pytest.raises(PoolExhausted, match="pool exhausted"):
        pool.alloc()
    with pytest.raises(PoolExhausted, match="cannot reserve"):
        pool.reserve(1)
    with pytest.raises(ValueError, match="double free"):
        pool.free(1)
    with pytest.raises(ValueError):
        KVPagePool(0, 4)


@settings(max_examples=30, deadline=None)
@given(toks=st.lists(st.integers(0, 2**40), max_size=20),
       parent=st.one_of(st.none(), st.binary(min_size=16, max_size=16)))
def test_chain_key_bytes_match_reference(toks, parent):
    assert KVPagePool.chain_key(parent, toks) == RefPool.chain_key(parent,
                                                                   toks)


# ---------------------------------------------------------------------------
# paged attention's plain version and the pool append
# ---------------------------------------------------------------------------

def _pools(rng, n_pages, page, bits):
    """Pools of encoded real values (random words may be NaN codes), as
    numpy: int32 words (bits > 0) or f32 rows."""
    kf = rng.standard_normal((n_pages, page, HKV, D)).astype(np.float32)
    vf = rng.standard_normal((n_pages, page, HKV, D)).astype(np.float32)
    if not bits:
        return kf, vf
    w = D * bits // 32
    return tuple(ref.pack_ref(torch.from_numpy(x.reshape(n_pages, page, -1)),
                              bits).reshape(n_pages, page, HKV, w).numpy()
                 for x in (kf, vf))


def _case(rng, page, bits, lens):
    """Shuffled page ids, entries past each live length on the scrap
    page 0, as the engine leaves them."""
    b, mp = len(lens), max(1, -(-max(lens) // page))
    n_pages = 1 + b * mp
    pk, pv = _pools(rng, n_pages, page, bits)
    q = rng.standard_normal((b, H, D)).astype(np.float32)
    table = rng.permutation(np.arange(1, n_pages))[: b * mp].astype(
        np.int32).reshape(b, mp)
    for i, ln in enumerate(lens):
        table[i, -(-ln // page):] = 0
    return q, pk, pv, table, np.asarray(lens, np.int32)


def _jax_in(x):
    return jnp.asarray(x.view(np.uint32) if x.dtype == np.int32
                       and x.ndim == 4 else x)


@pytest.mark.parametrize("bits", [0, 8, 16])
@pytest.mark.parametrize("page", [4, 8])
def test_paged_attention_ref_matches_reference(bits, page):
    """The plain version against the reference's Pallas kernel in
    interpret mode and its oracle: lengths 0, 1, page - 1, page,
    page + 1 and three full pages."""
    rng = np.random.default_rng(7 * page + bits)
    case = _case(rng, page, bits,
                 [0, 1, page - 1, page, page + 1, 3 * page])
    got = ref.paged_attention_ref(*map(torch.from_numpy, case), bits, D)
    q, pk, pv, table, kv_len = map(_jax_in, case)
    for want in (jax_paged_attention(q, pk, pv, table, kv_len, bits, D,
                                     interpret=True),
                 jref.paged_attention_ref(q, pk, pv, table, kv_len, bits,
                                          D)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    assert not got[0].any()                       # kv_len == 0 gives zeros
    # the dispatch's CPU route is the plain version
    out = ops.paged_attention(*map(torch.from_numpy, case), bits, D)
    assert torch.equal(out, got)


@pytest.mark.parametrize("bits", [0, 8])
def test_scrap_page_never_leaks(bits):
    """Large finite poison on the scrap page moves no output bit."""
    page = 4
    q, pk, pv, table, kv_len = _case(np.random.default_rng(3), page, bits,
                                     [1, page, 2 * page - 1])
    poison = (np.full((page, HKV, D), 1e4, np.float32) if not bits else
              ref.pack_ref(torch.full((page, HKV * D), 10.0), bits)
              .reshape(page, HKV, -1).numpy())
    args = [torch.from_numpy(x) for x in (q, pk, pv, table, kv_len)]
    clean = ref.paged_attention_ref(*args, bits, D)
    pk_p, pv_p = pk.copy(), pv.copy()
    pk_p[0], pv_p[0] = poison, poison
    dirty = ref.paged_attention_ref(args[0], torch.from_numpy(pk_p),
                                    torch.from_numpy(pv_p), *args[3:], bits, D)
    assert torch.equal(clean, dirty)


@pytest.mark.parametrize("bits", [0, 16])
def test_append_kv_pool_row_matches_reference(bits):
    """The pool append writes the reference's words at the reference's
    rows, dead slots (lengths past the table) clamped onto the scrap
    page."""
    rng = np.random.default_rng(bits)
    page, mp = 4, 3
    b = 4
    _, pk, pv, table, _ = _case(rng, page, bits, [5, 12, 0, 1])
    kv_len = np.array([5, 11, 12, 40], np.int32)
    k_new = rng.standard_normal((b, HKV, D)).astype(np.float32)
    v_new = rng.standard_normal((b, HKV, D)).astype(np.float32)
    want_k, want_v = ref_append(_jax_in(pk), _jax_in(pv), jnp.asarray(k_new),
                                jnp.asarray(v_new), jnp.asarray(table),
                                jnp.asarray(kv_len), bits or None)
    got_k, got_v = append_kv_pool_row(
        torch.from_numpy(pk.copy()), torch.from_numpy(pv.copy()),
        torch.from_numpy(k_new), torch.from_numpy(v_new),
        torch.from_numpy(table), torch.from_numpy(kv_len), bits or None)
    for got, want in ((got_k, want_k), (got_v, want_v)):
        want = np.asarray(want)
        np.testing.assert_array_equal(
            got.numpy(), want.view(np.int32) if bits else want)
    assert table.shape[1] == mp


# ---------------------------------------------------------------------------
# the paged engine against the reference's
# ---------------------------------------------------------------------------

def _cfg(get, kv_bits):
    cfg = get("qwen3_8b").reduced()
    return dataclasses.replace(cfg, compression=dataclasses.replace(
        cfg.compression, kv_bits=kv_bits))


def _traffic(name, vocab):
    """The bench's two traffics, drawn in its order from its seed."""
    rng = np.random.default_rng(23)
    cfg = types.SimpleNamespace(vocab_size=vocab)
    mixed = BENCH._mixed_prompts(cfg, rng)
    if name == "mixed":
        return [[int(t) for t in p] for p in mixed]
    return [[int(t) for t in p] for p in BENCH._shared_prompts(cfg, rng)]


# both traffics drain through one engine, mixed first, on the mixed
# leg's over-committed pool; prefill chunks of 2 keep the reference's
# compiled programs few (chunks of 1 and 2 tokens)
ENGINE_KW = dict(max_seq_len=SEQ, max_slots=SLOTS, pack_weights=True,
                 paged=True, kv_page_size=PAGE, kv_pool_pages=MIXED_POOL,
                 prefill_chunk=2)
TRAFFICS = ("mixed", "shared")


def _drain(eng, prompts, new=NEW):
    rids = [eng.submit(p, max_new_tokens=new) for p in prompts]
    stats = eng.run_until_drained()
    return [eng.result(r) for r in rids], stats


@functools.lru_cache(maxsize=None)
def _ref_engine(kv_bits):
    with mock.patch.object(ref_engine_module, "repack", _jitted_repack):
        return RefEngine(_cfg(ref_get_config, kv_bits), sample_seed=0,
                         **ENGINE_KW)


@functools.lru_cache(maxsize=None)
def _ref_params():
    """The reference engines' packed weights (the KV width does not
    change them) in interop's numpy form."""
    return _numpy_tree(_ref_engine(16).params)


@functools.lru_cache(maxsize=None)
def _ref_drains(kv_bits):
    """The reference engine's drains of both traffics: per traffic the
    outputs, the snapshot after it, and every decode call's input state,
    tokens and logits."""
    eng, cfg = _ref_engine(kv_bits), _cfg(ref_get_config, kv_bits)
    calls = []
    step = eng._step

    def recording(params, state, toks):
        before = {"len": np.array(state["len"]),
                  "table": np.array(state["table"]),
                  "kv": {n: np.array(state["kv"][n]) for n in ("k", "v")}}
        out = step(params, state, toks)
        calls.append((before, np.array(toks), np.asarray(out[0])))
        return out

    eng._step = recording
    res = {}
    for traffic in TRAFFICS:
        del calls[:]
        outs, stats = _drain(eng, _traffic(traffic, cfg.vocab_size))
        res[traffic] = (outs, stats, list(calls))
    return res


def _port_engine(kv_bits, **kw):
    return ServeEngine(_cfg(get_config, kv_bits),
                       params=params_from_numpy(_ref_params(), "cpu"),
                       device="cpu", **dict(ENGINE_KW, **kw))


@functools.lru_cache(maxsize=None)
def _port_drains(kv_bits):
    eng = _port_engine(kv_bits)
    res = {t: _drain(eng, _traffic(t, eng.cfg.vocab_size)) + (eng,)
           for t in TRAFFICS}
    return res


ENGINE_CASES = [(16, "mixed"), (16, "shared"), (None, "mixed"),
                (None, "shared")]


@pytest.mark.parametrize("kv_bits,traffic", ENGINE_CASES)
def test_paged_engine_matches_reference(kv_bits, traffic):
    """Identical greedy tokens and paged counters after each drain; the
    pool drains back to empty."""
    r_outs, r_stats, _ = _ref_drains(kv_bits)[traffic]
    p_outs, p_stats, eng = _port_drains(kv_bits)[traffic]
    assert all(o is not None and len(o) == NEW for o in r_outs)
    assert p_outs == r_outs
    for key in sorted(obs.schema.SNAPSHOT_KEYS_PAGED | {
            "ticks", "tokens", "decode_calls", "prefill_calls",
            "kv_rows_appended", "kv_bytes_appended", "finished_requests"}):
        assert p_stats[key] == r_stats[key], key
    assert p_stats["pool_pages_used"] == p_stats["pool_pages_reserved"] == 0
    if traffic == "shared":
        assert p_stats["prefix_hits"] > 0
    assert 0 < p_stats["kv_pages_read"] < p_stats["kv_pages_read_dense_equiv"]


@pytest.mark.parametrize("kv_bits,traffic", ENGINE_CASES)
def test_paged_decode_logits_match_reference(kv_bits, traffic):
    """Every decode call of the reference's drain, replayed on the port
    from the same paged state (pools, table, lengths) and tokens: logits
    within 1e-4 (f32; the two differ in summation order). Held per call
    and not along the port's own drain: there, a last-bit difference
    can round a K/V element to the neighbouring AF16 code, and later
    steps carry that on (the tokens stay identical)."""
    lm = LM(_cfg(get_config, kv_bits), device="cpu")
    params = params_from_numpy(_ref_params(), "cpu")
    calls = _ref_drains(kv_bits)[traffic][2]
    assert calls
    for before, toks, want in calls:
        state = {"len": torch.tensor(before["len"]),
                 "table": torch.tensor(before["table"]),
                 "kv": {n: torch.tensor(a.view(np.int32) if kv_bits else a)
                        for n, a in before["kv"].items()}}
        # slots holding a request; idle slots attend the scrap page,
        # whose rows every idle slot writes (in no fixed order)
        live = before["table"][:, 0] != 0
        logits, _ = lm.decode_step(params, state, torch.tensor(toks))
        np.testing.assert_allclose(logits.numpy()[live], want[live], rtol=0,
                                   atol=1e-4)


@pytest.mark.parametrize("kv_bits", [16, None])
def test_three_ways_identical(kv_bits):
    """dense, paged + gather and paged + fused give the same tokens on
    the first quarter of the mixed traffic; the gather route reads no
    pages through the table and the fused route gathers nothing."""
    prompts = _traffic("mixed", _cfg(get_config, 16).vocab_size)[:3]
    outs = {}
    for name, kw in (("dense", dict(paged=False)),
                     ("gather", dict(paged_attn=False)),
                     ("fused", {})):
        eng = _port_engine(kv_bits, **kw)
        ops.DISPATCH_RECORDS.clear()
        outs[name], stats = _drain(eng, prompts)
        paths = {(r.op, r.path) for r in ops.DISPATCH_RECORDS}
        if name == "fused":
            assert ("paged_attention", "fused_paged") in paths
            assert not any(op == "gather_kv_pages" for op, _ in paths)
        if name == "gather":
            assert ("gather_kv_pages", "materialized") in paths
            assert stats["kv_pages_read"] == 0
    assert outs["dense"] == outs["gather"] == outs["fused"]


def test_paged_snapshot_keys_match_reference():
    assert obs.snapshot_keys(paged=True) == ref_snapshot_keys(paged=True)
    _, stats, eng = _port_drains(16)["shared"]
    assert set(eng.metrics_snapshot()) == obs.snapshot_keys(paged=True)
    assert set(stats) == obs.drain_keys(paged=True)


def test_paged_decode_state_and_table_sync():
    """The paged state's shapes; after a drain the device table equals
    the host shadow on every row not marked dirty."""
    cfg = _cfg(get_config, 16)
    lm = LM(cfg, device="cpu")
    st_ = lm.init_paged_decode_state(3, 32, 8, 10)
    assert st_["table"].shape == (3, 4) and st_["table"].dtype == torch.int32
    assert st_["kv"]["k"].shape == (cfg.n_layers, 11, 8, cfg.n_kv_heads,
                                    cfg.resolved_head_dim * 16 // 32)
    with pytest.raises(ValueError, match="must divide"):
        lm.init_paged_decode_state(3, 30, 8, 10)
    _, stats, eng = _port_drains(16)["mixed"]
    clean = [s for s in range(eng.n_slots) if s not in eng._dirty_rows]
    assert (eng.state["table"].numpy()[clean] == eng._table[clean]).all()
    assert 0 < stats["table_uploads"] < stats["decode_calls"] + stats[
        "prefill_calls"]


# ---------------------------------------------------------------------------
# error contract and bookkeeping
# ---------------------------------------------------------------------------

def _small(**kw):
    return ServeEngine(_cfg(get_config, 16), device="cpu",
                       **dict(dict(max_seq_len=64, max_slots=2, paged=True,
                                   kv_page_size=8), **kw))


def test_submit_error_names_mode():
    with pytest.raises(ValueError, match=r"dense KV mode"):
        _small(max_seq_len=16, paged=False).submit(list(range(1, 30)), 4)
    with pytest.raises(ValueError, match=r"paged KV mode: page table"):
        _small(max_seq_len=16).submit(list(range(1, 30)), 4)


def test_paged_refuses_what_is_not_ported():
    """A recurrent family has no KV rows to page: the port refuses paged
    mode for it with the reference's ValueError."""
    with pytest.raises(ValueError, match="paged KV mode refused"):
        ServeEngine(get_config("falcon_mamba_7b").reduced(), max_slots=2,
                    paged=True, device="cpu")


def test_page_size_must_divide_seq_len():
    with pytest.raises(ValueError, match="must divide"):
        _small(max_seq_len=60, kv_page_size=16)


def test_pool_exhausted_mid_flight_names_paged_mode():
    eng = _small(kv_pool_pages=8)
    rid = eng.submit([1, 2], max_new_tokens=4)
    req = eng._active[rid]
    req.reserved_pages = 0                 # sabotage the guarantee
    eng.pool._reserved = 0
    while eng.pool.free_pages:
        eng.pool.alloc()
    with pytest.raises(PoolExhausted, match="paged KV mode"):
        eng._ensure_rows(req, 30)


def test_registration_waits_for_prefill():
    """Sharers admitted in the same batch as the writer miss (their
    pages are not written yet) and still agree with a dense run."""
    system = list(range(1, 25))
    prompts = [[1]] * 3 + [system + [100 + i] for i in range(3)]
    eng = _small(max_slots=3)
    rids = [eng.submit(p, max_new_tokens=2) for p in prompts]
    stats = eng.run_until_drained()
    assert stats["prefix_hits"] == 0
    dense = _small(max_slots=3, paged=False)
    d_rids = [dense.submit(p, max_new_tokens=2) for p in prompts]
    dense.run_until_drained()
    assert [eng.result(r) for r in rids] == [dense.result(r) for r in d_rids]


def test_copy_on_write_splits_shared_tail():
    eng = _small()
    rid = eng.submit(list(range(1, 9)), max_new_tokens=4)
    req = eng._active[rid]
    page = int(eng._table[req.slot, 0])
    eng.state["kv"]["k"][:, page] = 7
    eng.pool.retain(page)                  # an outside sharer
    req.prefix_keys = []                   # outside any registered prefix
    req.kv_len = 7                         # the next append lands in page 0
    eng._ensure_tail_private(req)
    fresh = int(eng._table[req.slot, 0])
    assert fresh != page and eng._cow_copies == 1
    assert eng.pool.refcount(page) == 1 and eng.pool.refcount(fresh) == 1
    assert (eng.state["kv"]["k"][:, fresh] == 7).all()
    eng.pool.free(page)
