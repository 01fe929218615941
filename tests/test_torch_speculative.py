"""The port's speculative and sampled serving against the JAX reference,
on the CPU.

One reference ``SpeculativeEngine`` (reduced qwen3_8b, AF16 packed
weights and KV, an AF12 draft with an AF12 KV cache, k = 2, 2 slots, 3
short prompts) is built and drained once per module; the port's
engines, dense and paged, drain the same requests on its converted
target weights and derive their own draft. Greedy tokens, per-request
acceptance and the draft counters must equal the reference's, and the
port's draft words must equal the reference's draft words. Sampling
matches the reference in distribution only (JAX's PRNG streams cannot
be reproduced): the rejection sampler and the plain sampler are held to
their target distributions over V = 8, within a stated total-variation
bound.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import types
from unittest import mock

import numpy as np
import pytest
import torch

import repro.serving.engine as ref_engine_module
import repro.serving.speculative as ref_spec_module
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.core.compress import CompressionPlan as RefPlan
from repro.core.compress import derive_plan as ref_derive_plan
from repro.obs import drain_keys as ref_drain_keys
from repro.obs import snapshot_keys as ref_snapshot_keys
from repro.serving import DraftController as RefController
from repro.serving import SpeculativeEngine as RefSpeculative
from repro.serving import resolve_draft_bits as ref_resolve_draft_bits
from repro.serving import resolve_draft_kv_bits as ref_resolve_draft_kv_bits

from repro_torch import obs
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.compress import CompressionPlan, derive_plan
from repro_torch.core.tensor_store import is_packed, tree_leaves
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.serving import (DraftController, ServeEngine,
                                 SpeculativeEngine, resolve_draft_bits,
                                 resolve_draft_kv_bits)
from test_torch_serve import (_jitted_repack, _numpy_tree,  # noqa: F401
                              one_torch_thread)

K, SLOTS, MAX_SEQ, CHUNK, NEW = 2, 2, 24, 4, 4
# more requests than slots, an empty prompt, a prompt past the chunk
PROMPT_LENS = (5, 0, 9)
SHORT = [[17, 4, 9], [300]]     # one request a slot, one chunk
# total variation between an empirical and its target distribution over
# V = 8 outcomes: the expected value at 20,000 draws is ~0.01
TV_BOUND = 0.03


def _prompts():
    rng = np.random.default_rng(11)
    return [[int(t) for t in rng.integers(1, 512, n)] for n in PROMPT_LENS]


def _drain(eng, prompts=None):
    rids = [eng.submit(p, max_new_tokens=NEW)
            for p in (_prompts() if prompts is None else prompts)]
    reqs = {r.rid: r for r in itertools.chain(eng._active.values(),
                                              eng._queue)}
    stats = eng.run_until_drained()
    return {"engine": eng, "stats": stats,
            "outs": [eng.result(r) for r in rids],
            "acceptance": [(reqs[r].draft_proposed, reqs[r].draft_accepted)
                           for r in rids]}


@pytest.fixture(scope="module")
def ref():
    cfg = ref_get_config("qwen3_8b").reduced()
    with mock.patch.object(ref_engine_module, "repack", _jitted_repack), \
            mock.patch.object(ref_spec_module, "repack", _jitted_repack):
        eng = RefSpeculative(cfg, max_seq_len=MAX_SEQ, max_slots=SLOTS,
                             pack_weights=True, prefill_chunk=CHUNK,
                             sample_seed=0, k=K)
    out = _drain(eng)
    out.update(params=_numpy_tree(eng.params),
               draft_params=_numpy_tree(eng.draft_params))
    return out


def _engine(ref, cls=SpeculativeEngine, **kw):
    kw = dict(dict(max_seq_len=MAX_SEQ, max_slots=SLOTS, pack_weights=True,
                   prefill_chunk=CHUNK, sample_seed=0, device="cpu"), **kw)
    if cls is SpeculativeEngine:
        kw.setdefault("k", K)
    return cls(get_config("qwen3_8b").reduced(),
               params=params_from_numpy(ref["params"], device="cpu"), **kw)


@pytest.fixture(scope="module", params=["dense", "paged"])
def port(request, ref):
    paged = request.param == "paged"
    eng = _engine(ref, paged=paged, kv_page_size=4)
    ops.DISPATCH_RECORDS.clear()
    out = _drain(eng)
    out.update(paged=paged, records=list(ops.DISPATCH_RECORDS))
    return out


@pytest.fixture(scope="module")
def plain(ref):
    return _drain(_engine(ref, cls=ServeEngine))


def test_tokens_and_acceptance_match_reference(ref, port, plain):
    assert all(o is not None and len(o) == NEW for o in ref["outs"])
    assert port["outs"] == ref["outs"]
    assert port["outs"] == plain["outs"]
    assert port["acceptance"] == ref["acceptance"]
    if port["paged"]:
        pool = port["engine"].pool
        assert pool.used == 0 and pool.reserved == 0


def test_counters_match_reference(ref, port):
    for key in ("tokens", "ticks", "spec_ticks", "slot_ticks", "proposed",
                "accepted", "acceptance_rate", "committed_per_slot_tick",
                "k", "initial_k", "draft_bits", "draft_kv_bits",
                "decode_calls", "prefill_calls", "weight_passes",
                "kv_rows_appended", "kv_rows_committed", "kv_bytes_appended",
                "draft_weight_passes", "draft_weight_read_bytes_fused",
                "draft_weight_read_bytes_dense", "draft_fused_bytes_per_pass",
                "draft_fused_analytic_bytes_per_pass",
                "draft_kv_bytes_appended"):
        assert port["stats"][key] == ref["stats"][key], key
    assert port["stats"]["draft_bits"] == 12
    assert port["stats"]["draft_kv_bits"] == 12


def test_snapshot_keys_match_reference(port):
    paged = port["paged"]
    assert obs.snapshot_keys(paged, speculative=True) == ref_snapshot_keys(
        paged=paged, speculative=True)
    assert set(port["engine"].metrics_snapshot()) == obs.snapshot_keys(
        paged, speculative=True)
    assert set(port["stats"]) == obs.drain_keys(paged, speculative=True)
    assert obs.drain_keys(paged, True, True) == ref_drain_keys(
        paged, True, True)


def test_draft_words_match_reference(ref):
    """The port's repack derives the reference's draft, word for word,
    and leaves the target's tree as it was (the port's repack works in
    place; the draft takes fresh containers)."""
    eng = _engine(ref)
    ours, theirs = eng.draft_params, params_from_numpy(ref["draft_params"],
                                                       device="cpu")
    target = params_from_numpy(ref["params"], device="cpu")
    for a, b, t in zip(tree_leaves(ours), tree_leaves(theirs),
                       tree_leaves(target)):
        assert is_packed(a) == is_packed(b)
        if is_packed(a):
            assert (a.bits, a.logical_shape) == (b.bits, b.logical_shape)
            assert torch.equal(a.data, b.data)
        else:
            assert torch.equal(a, b)
    for leaf, t in zip(tree_leaves(eng.params), tree_leaves(target)):
        if is_packed(leaf):
            assert leaf.bits == 16 and torch.equal(leaf.data, t.data)
    assert eng.draft_weight_read_bytes < eng.weight_read_bytes


def test_draft_runs_packed_matmul_at_its_width(port):
    """The draft's passes go through packed_matmul at AF12 and its AF12
    cache through kv_decode / paged_attention; no unpack op and no
    materialized decode of a weight of rank 2 or more."""
    eng = port["engine"]
    st = (eng.draft_lm.init_paged_decode_state(SLOTS, MAX_SEQ, 4, 12)
          if port["paged"] else eng.draft_lm.init_decode_state(SLOTS, MAX_SEQ))
    if port["paged"]:
        st["table"] = torch.arange(SLOTS * 6, dtype=torch.int32).reshape(
            SLOTS, 6) + 1
    ops.DISPATCH_RECORDS.clear()
    ops.FALLBACK_RECORDS.clear()
    drafts, dlogits, st = eng._draft_k(eng.draft_params, st,
                                       torch.tensor([[3], [7]]))
    recs = list(ops.DISPATCH_RECORDS)
    assert drafts.shape == (SLOTS, K) and dlogits is None
    assert st["len"].tolist() == [K + 1] * SLOTS
    pmm = {r.bits for r in recs if r.op == "packed_matmul"}
    assert pmm == {12}
    attn = "paged_attention" if port["paged"] else "kv_decode"
    assert {r.bits for r in recs if r.op == attn} == {12}
    assert {r.bits for r in recs if r.op == "take_rows"} == {12}
    assert not any(r.op == "unpack" for r in recs)
    assert not any(r.path == "materialized" and len(r.shape) >= 2
                   for r in recs), recs
    assert not ops.FALLBACK_RECORDS
    # the drain itself ran both widths of the product
    assert {r.bits for r in port["records"] if r.op == "packed_matmul"} \
        == {12, 16}


def _plan_cases():
    rng = np.random.default_rng(4)
    ladder = (8, 12, 16, 20, 24, 28, 32)
    plans = [RefPlan(float_bits={"a": 16, "b": 8, "c": 32},
                     int_bits={"i": (12, False)}, tune_evals=3,
                     kv_bits={"kv/layer_0": 16, "kv/layer_1": 8})]
    for _ in range(4):
        plans.append(RefPlan(
            float_bits={f"blocks/w{i}": int(rng.choice(ladder))
                        for i in range(5)},
            int_bits={"idx": (int(rng.integers(2, 17)), bool(rng.integers(2)))},
            kv_bits={f"kv/layer_{i}": int(rng.choice(ladder))
                     for i in range(3)}))
    return plans


@pytest.mark.parametrize("delta", [0, 4, 8, 12])
def test_derive_plan_matches_reference(delta):
    for rp in _plan_cases():
        ours = derive_plan(CompressionPlan.from_jsonable(rp.to_jsonable()),
                           delta)
        theirs = ref_derive_plan(rp, delta)
        assert json.dumps(ours.to_jsonable(), sort_keys=True) == json.dumps(
            theirs.to_jsonable(), sort_keys=True)
        assert ours.kv_layer_widths(4, 16) == theirs.kv_layer_widths(4, 16)
    plan = CompressionPlan(float_bits={"a": 8}, int_bits={})
    assert derive_plan(plan, 0).float_bits is not plan.float_bits
    with pytest.raises(ValueError):
        derive_plan(plan, -4)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_resolve_draft_widths_match_reference(arch):
    assert ARCHS == REF_ARCHS
    for ours, theirs in ((get_config(arch), ref_get_config(arch)),
                         (get_config(arch).reduced(),
                          ref_get_config(arch).reduced())):
        variants = [({}, {}), ({"kv_bits": 8}, {"kv_bits": 8}),
                    ({"draft_weight_bits": 10, "draft_kv_bits": 13},) * 2,
                    ({"kv_bits": None, "weight_bits": 24},) * 2]
        for mine, ref_kw in variants:
            a = dataclasses.replace(ours, compression=dataclasses.replace(
                ours.compression, **mine))
            b = dataclasses.replace(theirs, compression=dataclasses.replace(
                theirs.compression, **ref_kw))
            assert resolve_draft_bits(a) == ref_resolve_draft_bits(b)
            assert resolve_draft_kv_bits(a) == ref_resolve_draft_kv_bits(b)


def test_controller_decides_as_the_reference():
    kw = dict(floor=0.4, ceiling=0.9, min_k=2)
    ours, theirs = DraftController(**kw), RefController(**kw)
    for ewma, dbits, k, wbits in itertools.product(
            (0.0, 0.39, 0.4, 0.6, 0.9, 0.91, 1.0), (8, 12, 16, 20),
            (1, 2, 4), (12, 16, 24)):
        if dbits < wbits:
            assert ours.decide(ewma, dbits, k, wbits) == theirs.decide(
                ewma, dbits, k, wbits)
    assert ours.update(None, 0.3) == theirs.update(None, 0.3)
    assert ours.update(0.5, 0.3) == theirs.update(0.5, 0.3)
    with pytest.raises(ValueError):
        DraftController(floor=0.9, ceiling=0.5)


def test_accept_greedy_prefix_rule():
    stub = types.SimpleNamespace(k=3)
    drafts = np.array([[5, 6, 7], [5, 6, 7], [5, 6, 7], [1, 2, 3]])
    cand = np.array([[5, 6, 7, 8],      # all agree: 3 drafts + bonus
                     [5, 9, 7, 8],      # second differs: its token ends it
                     [4, 6, 7, 8],      # first differs
                     [1, 2, 4, 4]])
    assert SpeculativeEngine._accept_greedy(stub, drafts, cand) == [
        [5, 6, 7, 8], [5, 9], [4], [1, 2, 4]]


def _tv(draws, p):
    freq = np.bincount(draws, minlength=p.shape[0]) / draws.shape[0]
    return 0.5 * np.abs(freq - p).sum()


def test_accept_sampled_commits_the_target_distribution():
    """Draft tokens drawn from p_d, then rejection sampling: the first
    committed token follows p_t (20,000 draws, TV < TV_BOUND), though
    p_d differs from p_t by TV 0.45."""
    rng = np.random.default_rng(7)
    v, rows, k = 8, 4000, 2
    p_t = np.array([0.30, 0.20, 0.15, 0.10, 0.10, 0.05, 0.05, 0.05])
    p_d = np.array([0.05, 0.05, 0.10, 0.10, 0.15, 0.15, 0.20, 0.20])
    assert 0.5 * np.abs(p_t - p_d).sum() == pytest.approx(0.45)
    vlogits = torch.from_numpy(np.log(p_t)).float().expand(rows, k + 1, v)
    dlogits = torch.from_numpy(np.log(p_d)).float().expand(rows, k, v)
    first, accepted = [], 0
    for tick in range(5):
        stub = types.SimpleNamespace(k=k, _sample_nonce=0, ticks=tick)
        drafts = rng.choice(v, size=(rows, k), p=p_d)
        out = SpeculativeEngine._accept_sampled(
            stub, drafts, torch.from_numpy(drafts), vlogits, dlogits)
        assert all(1 <= len(t) <= k + 1 for t in out)
        first += [t[0] for t in out]
        accepted += sum(len(t) - 1 for t in out)
    assert _tv(np.array(first), p_t) < TV_BOUND
    # each draft is accepted with probability a = sum(min(p_t, p_d)) =
    # 1 - TV = 0.55, the second only after the first: (a + a^2) / k
    assert accepted / (5 * rows * k) == pytest.approx(
        (0.55 + 0.55 ** 2) / k, abs=0.03)


def test_plain_sampling_reproducible_and_distributed(ref):
    """A fixed sample_seed reproduces a drain, another seed changes it;
    the tick sampler follows the softmax (64 slots of equal logits over
    V = 8, 300 ticks: 19,200 draws, TV < TV_BOUND), slots with equal
    logits draw apart, and so do two ticks and two nonces."""
    runs = {}
    for seed in (5, 5, 6):
        d = _drain(_engine(ref, cls=ServeEngine, greedy=False,
                           sample_seed=seed), SHORT)
        assert all(len(o) == NEW for o in d["outs"])
        runs.setdefault(seed, []).append(d["outs"])
    assert runs[5][0] == runs[5][1]
    assert runs[6][0] != runs[5][0]

    eng = _engine(ref, cls=ServeEngine, greedy=False, sample_seed=1)
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -0.5, -1.0, 0.3, 1.5])
    p = torch.softmax(logits, 0).numpy()
    draws = []
    for t in range(300):
        eng.ticks = t
        draws.append(eng._sample_tokens(logits.expand(64, 8)).numpy())
    draws = np.stack(draws)
    assert _tv(draws.reshape(-1), p) < TV_BOUND
    assert (draws != draws[:, :1]).any(axis=1).mean() > 0.9   # slots
    assert (draws[1:] != draws[:-1]).any(axis=1).mean() > 0.9  # ticks
    other = _engine(ref, cls=ServeEngine, greedy=False, sample_seed=2)
    assert not torch.equal(other._sample_tokens(logits.expand(64, 8)),
                           eng._sample_tokens(logits.expand(64, 8)))


def test_sampled_speculation_drains(ref):
    d = _drain(_engine(ref, greedy=False, sample_seed=3), SHORT)
    again = _drain(_engine(ref, greedy=False, sample_seed=3), SHORT)
    assert all(len(o) == NEW for o in d["outs"])
    assert d["outs"] == again["outs"]
    assert 0 <= d["stats"]["accepted"] <= d["stats"]["proposed"]


def test_adaptive_narrowing_keeps_tokens(ref, plain):
    """A controller that must narrow (any acceptance above 0.01 after
    one tick): the draft re-derives at AF8 into a new tree, the draft LM
    serves that tree, and the tokens stay the plain engine's."""
    ctl = DraftController(floor=0.0, ceiling=0.01, min_proposals=1)
    eng = _engine(ref, adaptive=True, controller=ctl)
    tree = eng.draft_params
    ops.DISPATCH_RECORDS.clear()
    d = _drain(eng)
    assert d["outs"] == plain["outs"]
    ev = d["stats"]["retune_events"]
    assert d["stats"]["adaptive"] and ev
    assert (ev[0]["action"], ev[0]["from_bits"], ev[0]["to_bits"]) == (
        "narrow", 12, 8)
    assert eng.draft_bits == 8 and eng.draft_params is not tree
    assert eng.draft_lm._views[0] is eng.draft_params
    assert {r.bits for r in ops.DISPATCH_RECORDS
            if r.op == "packed_matmul"} == {8, 12, 16}
    assert set(d["stats"]) == obs.drain_keys(False, True, True)


def test_speculation_refuses_bad_widths_and_headroom(ref):
    with pytest.raises(ValueError, match="narrower"):
        _engine(ref, draft_bits=16)
    with pytest.raises(ValueError, match="k must be"):
        _engine(ref, k=0)
    eng = _engine(ref)
    with pytest.raises(ValueError, match="headroom 2"):
        eng.submit([1] * 20, max_new_tokens=4)
