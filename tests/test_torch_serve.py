"""The port's serving path against the JAX reference, on the CPU.

One reference ``ServeEngine`` (reduced qwen3_8b, AF16 packed weights and
AF16 packed KV) is built and drained once per module; its packed
parameters are converted with ``repro_torch.interop`` and the port's
engine, on ``device="cpu"`` (the plain versions of the kernels), drains
the same requests.
"""
from __future__ import annotations

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as ref_engine_module
from repro.configs import ARCHS as REF_ARCHS
from repro.core.compress import repack as ref_repack
from repro.configs import get_config as ref_get_config
from repro.core.tensor_store import PackedTensor as RefPacked
from repro.obs import snapshot_keys as ref_snapshot_keys
from repro.serving import ServeEngine as RefEngine

from repro_torch import obs
from repro_torch.configs import ARCHS, get_config
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models.lm import LM
from repro_torch.serving import ServeEngine

SLOTS = 2
MAX_SEQ = 24
CHUNK = 4
NEW = 4
# more requests than slots, an empty prompt, prompts longer than the
# prefill chunk; every remainder keeps to the one chunk bucket of 4
PROMPT_LENS = (5, 0, 9, 1)


def _numpy_tree(tree):
    """The reference's parameter tree in interop's numpy form."""
    if isinstance(tree, RefPacked):
        return {"data": np.asarray(tree.data), "bits": tree.bits,
                "kind": tree.kind, "signed": tree.signed,
                "logical_shape": tuple(tree.logical_shape),
                "out_dtype": jnp.dtype(tree.out_dtype).name}
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def _prompts():
    rng = np.random.default_rng(11)
    return [[int(t) for t in rng.integers(1, 512, n)] for n in PROMPT_LENS]


def _jitted_repack(tree, plan):
    """The reference's own ``repack``, jitted: the same integer
    programs, without packing leaf by leaf at eager speed."""
    return jax.jit(functools.partial(ref_repack, plan=plan))(tree)


@pytest.fixture(scope="module")
def ref():
    cfg = ref_get_config("qwen3_8b").reduced()
    with mock.patch.object(ref_engine_module, "repack", _jitted_repack):
        eng = RefEngine(cfg, max_seq_len=MAX_SEQ, max_slots=SLOTS,
                        pack_weights=True, prefill_chunk=CHUNK,
                        sample_seed=0)
    rids = [eng.submit(p, max_new_tokens=NEW) for p in _prompts()]
    stats = eng.run_until_drained()
    outs = [eng.result(r) for r in rids]
    return {"engine": eng, "outs": outs, "stats": stats,
            "params": _numpy_tree(eng.params)}


@pytest.fixture(scope="module")
def port(ref):
    cfg = get_config("qwen3_8b").reduced()
    params = params_from_numpy(ref["params"], device="cpu")
    eng = ServeEngine(cfg, max_seq_len=MAX_SEQ, max_slots=SLOTS,
                      pack_weights=True, prefill_chunk=CHUNK,
                      params=params, device="cpu")
    ops.DISPATCH_RECORDS.clear()
    rids = [eng.submit(p, max_new_tokens=NEW) for p in _prompts()]
    stats = eng.run_until_drained()
    return {"engine": eng, "outs": [eng.result(r) for r in rids],
            "stats": stats, "records": list(ops.DISPATCH_RECORDS)}


def test_greedy_tokens_identical(ref, port):
    assert all(o is not None and len(o) == NEW for o in ref["outs"])
    assert port["outs"] == ref["outs"]
    assert port["stats"]["ticks"] == ref["stats"]["ticks"]


def test_counters_match_reference(ref, port):
    for key in ("tokens", "decode_calls", "prefill_calls", "weight_passes",
                "kv_rows_appended", "fused_bytes_per_pass",
                "fused_analytic_bytes_per_pass", "dense_bytes_per_pass",
                "weight_read_bytes_fused", "kv_bytes_appended"):
        assert port["stats"][key] == ref["stats"][key], key


def test_decode_step_logits_match(ref):
    """Two decode steps from a fresh state: logits within atol 1e-4
    (f32; the two sides differ only in summation order)."""
    eng = ref["engine"]
    cfg = get_config("qwen3_8b").reduced()
    lm = LM(cfg, device="cpu")
    params = params_from_numpy(ref["params"], device="cpu")
    state = lm.init_decode_state(SLOTS, MAX_SEQ)
    ref_state = eng.lm.init_decode_state(SLOTS, MAX_SEQ)
    rng = np.random.default_rng(5)
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (SLOTS, 1)).astype(np.int32)
        ref_logits, ref_state = eng._step(eng.params, ref_state,
                                          jnp.asarray(toks))
        logits, state = lm.decode_step(params, state, torch.from_numpy(toks))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=0, atol=1e-4)
    np.testing.assert_array_equal(state["len"].numpy(),
                                  np.asarray(ref_state["len"]))


def test_every_kernel_op_dispatched(port):
    ops_seen = {(r.op, r.path) for r in port["records"]}
    for op, path in (("packed_matmul", "fused"), ("pack", "encode"),
                     ("kv_decode", "kv_decode"), ("take_rows", "take")):
        assert (op, path) in ops_seen, (op, path)


def test_snapshot_key_set_matches_reference(ref, port):
    assert obs.snapshot_keys() == ref_snapshot_keys(paged=False,
                                                    speculative=False)
    assert set(port["engine"].metrics_snapshot()) == set(
        ref["engine"].metrics_snapshot())
    assert set(port["stats"]) == obs.drain_keys()


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_configs_match_reference(arch):
    """The jax-free configs equal the reference's field for field, full
    and reduced."""
    assert ARCHS == REF_ARCHS
    for ours, theirs in ((get_config(arch), ref_get_config(arch)),
                         (get_config(arch).reduced(),
                          ref_get_config(arch).reduced())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
        assert ours.n_params() == theirs.n_params()
        assert ours.kv_bytes_per_token() == theirs.kv_bytes_per_token()
        assert str(ours.compute_dtype).endswith(str(theirs.compute_dtype))


def test_unported_modes_raise():
    cfg = get_config("qwen3_8b").reduced()
    for kw, item in (({"paged": True}, "A10"), ({"greedy": False}, "A11")):
        with pytest.raises(NotImplementedError, match=item):
            ServeEngine(cfg, max_slots=1, device="cpu", **kw)


def test_kv_append_clamps_like_the_reference():
    """Rows appended at len >= S land on row S - 1, as the reference's
    dynamic_update_slice clamps them (padding rows and idle slots)."""
    from repro.models.attention import update_kv_cache as ref_update

    from repro_torch.models.attention import update_kv_cache

    rng = np.random.default_rng(3)
    b, s, hkv, d, bits = 4, 6, 2, 32, 16
    k_new = rng.standard_normal((b, hkv, d)).astype(np.float32)
    v_new = rng.standard_normal((b, hkv, d)).astype(np.float32)
    words = rng.integers(0, 2**31, (b, s, hkv, bits), dtype=np.int64)
    cache = words.astype(np.int32)
    kv_len = np.array([0, s - 1, s, s + 5], np.int32)
    want_k, want_v = ref_update(
        jnp.asarray(cache.view(np.uint32)), jnp.asarray(cache.view(np.uint32)),
        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(kv_len), bits)
    kc, vc = torch.from_numpy(cache.copy()), torch.from_numpy(cache.copy())
    got_k, got_v = update_kv_cache(kc, vc, torch.from_numpy(k_new),
                                   torch.from_numpy(v_new),
                                   torch.from_numpy(kv_len), bits)
    np.testing.assert_array_equal(got_k.numpy(),
                                  np.asarray(want_k).view(np.int32))
    np.testing.assert_array_equal(got_v.numpy(),
                                  np.asarray(want_v).view(np.int32))


def test_verify_prefill_and_rollback(ref):
    """verify_step is T decode steps; prefill_step appends the same rows
    and sets len = len0 + n_valid; rollback resets len only."""
    cfg = get_config("qwen3_8b").reduced()
    lm = LM(cfg, device="cpu")
    params = params_from_numpy(ref["params"], device="cpu")
    toks = torch.from_numpy(
        np.random.default_rng(9).integers(0, cfg.vocab_size, (SLOTS, 3)))
    st_a = lm.init_decode_state(SLOTS, MAX_SEQ)
    logits_v, st_a = lm.verify_step(params, st_a, toks)
    st_b = lm.init_decode_state(SLOTS, MAX_SEQ)
    for t in range(3):
        logits_t, st_b = lm.decode_step(params, st_b, toks[:, t:t + 1])
        torch.testing.assert_close(logits_v[:, t], logits_t[:, 0],
                                   rtol=0, atol=0)
    st_c = lm.prefill_step(params, lm.init_decode_state(SLOTS, MAX_SEQ), toks,
                           torch.tensor([3, 1], dtype=torch.int32))
    assert st_c["len"].tolist() == [3, 1]
    assert torch.equal(st_c["kv"]["k"][:, 0, :3], st_a["kv"]["k"][:, 0, :3])
    assert torch.equal(st_c["kv"]["v"][:, 1, :1], st_a["kv"]["v"][:, 1, :1])
    st_d = lm.rollback_decode_state(st_a, [1, 2])
    assert st_d["len"].tolist() == [1, 2]
    assert st_d["kv"]["k"] is st_a["kv"]["k"]


def test_residency_planner_matches_reference():
    """decode_residency gives the reference's numbers on the reference's
    chip record; the port's default is the H100 record."""
    from repro.core import occupancy as ref_occ

    from repro_torch.core import occupancy as occ

    cfg = get_config("qwen3_8b")
    args = dict(weight_bytes=cfg.n_params() * 2,
                kv_bytes_per_token=cfg.kv_bytes_per_token(), seq_len=256)
    ours = occ.decode_residency(chip=occ.TPU_V5E, **args)
    theirs = ref_occ.decode_residency(chip=ref_occ.TPU_V5E, **args)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert occ.decode_residency(**args).max_sequences > ours.max_sequences
