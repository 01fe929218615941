"""The port's MoE serving path against the JAX reference, on the CPU.

Reduced deepseek-moe-16b (2 layers, d_model 128, 8 experts of width 64,
top-2, 2 shared experts). The reference's parameters are made once per
module, packed at AF16 by the reference's own ``repack`` and converted
with ``repro_torch.interop``; every test feeds both packages the same
numpy-seeded inputs. The JAX side runs as its own tests run it on the
CPU (the jnp oracles of its kernels). Tolerances: f32 throughout, the
two sides differ only in summation order (1e-5 for single blocks, 1e-4
for logits after two layers). The ``cuda`` tests decide inside a fixture
whether there is a card and skip without one; on the card they run with
``python -m pytest tests/test_torch_moe.py -k cuda``. The reference is
imported in a fixture (``R``), so they also run where JAX is missing.
"""
from __future__ import annotations

import functools
import types
from unittest import mock

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.configs import get_config
from repro_torch.core.compress import repack, uniform_plan
from repro_torch.core.formats import FLOAT_LADDER
from repro_torch.core.tensor_store import PackedTensor, is_packed, pack_tensor
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.lm import LM, layer_slice
from repro_torch.serving import ServeEngine

ARCH = "deepseek_moe_16b"
SLOTS = 3
MAX_SEQ = 24
CHUNK = 4
NEW = 4
# more requests than slots, an empty prompt, prompts longer than the chunk
PROMPT_LENS = (6, 0, 9, 2, 3)


@pytest.fixture(scope="module")
def R():
    """jax and the reference's modules."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import repro.serving.engine as engine_module
    from repro.compat import prng_key
    from repro.configs import get_config as ref_get_config
    from repro.core.compress import repack, uniform_plan as ref_uniform_plan
    from repro.core.tensor_store import PackedTensor as RefPacked
    from repro.kernels import ref as kref
    from repro.models import blocks, layers
    from repro.models.lm import LM as RefLM
    from repro.serving import ServeEngine as RefEngine

    def numpy_tree(tree):
        """The reference's parameter tree in interop's numpy form."""
        if isinstance(tree, RefPacked):
            return {"data": np.asarray(tree.data), "bits": tree.bits,
                    "kind": tree.kind, "signed": tree.signed,
                    "logical_shape": tuple(tree.logical_shape),
                    "out_dtype": jnp.dtype(tree.out_dtype).name}
        if isinstance(tree, dict):
            return {k: numpy_tree(v) for k, v in tree.items()}
        return np.asarray(tree)

    def jitted_repack(tree, plan):
        """The reference's own ``repack``, jitted: the same integer
        programs, without packing leaf by leaf at eager speed."""
        return jax.jit(functools.partial(repack, plan=plan))(tree)

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, engine_module=engine_module, prng_key=prng_key,
        get_config=ref_get_config, uniform_plan=ref_uniform_plan,
        kref=kref, B=blocks, L=layers, LM=RefLM, Engine=RefEngine,
        numpy_tree=numpy_tree, jitted_repack=jitted_repack)


def _prompts():
    rng = np.random.default_rng(13)
    return [[int(t) for t in rng.integers(1, 512, n)] for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def cfg():
    return get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def rcfg(R):
    return R.get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def trees(R, rcfg):
    """The reference's params packed at AF16, as the reference's tree and
    as the port's."""
    params = R.LM(rcfg).init(R.prng_key(0))
    packed = R.jitted_repack(params, R.uniform_plan(params, 16))
    return {"ref": packed, "ref_dense": params,
            "port": params_from_numpy(R.numpy_tree(packed), device="cpu")}


def _layer0(R, trees):
    """Layer 0's MoE parameters on both sides: stacked leaves sliced (the
    expert banks become 3-D packed banks)."""
    ref_moe = R.jax.tree_util.tree_map(lambda a: a[0],
                                       trees["ref"]["blocks"]["moe"])
    return ref_moe, layer_slice(trees["port"]["blocks"]["moe"], 0)


def _x(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the plain version of the batched kernel against the reference's oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("bits", FLOAT_LADDER)
def test_ref_packed_matmul_batched(R, transpose, bits):
    """All seven widths, both orientations, a ragged N and K (37 and 70:
    neither a multiple of 32), f32 and bf16 activations."""
    rng = np.random.default_rng(500 + bits)
    e, c, k, n = 3, 2, 70, 37
    rows, cols = (n, k) if transpose else (k, n)
    w = (rng.standard_normal((e, rows, cols)) / np.sqrt(k)).astype(np.float32)
    wp = ref.pack_ref(torch.from_numpy(w), bits).numpy()
    for x in (_x(rng, (e, c, k)),
              torch.from_numpy(_x(rng, (e, c, k))).bfloat16().float().numpy()):
        want = np.asarray(R.kref.packed_matmul_batched_ref(
            R.jnp.asarray(x), R.jnp.asarray(wp.view(np.uint32)), bits, n,
            transpose))
        got = ref.packed_matmul_batched_ref(
            torch.from_numpy(x), torch.from_numpy(wp), bits, n, transpose)
        assert got.shape == (e, c, n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_ops_dispatch_batched_records_fused_batched():
    rng = np.random.default_rng(1)
    wp = ref.pack_ref(torch.from_numpy(_x(rng, (2, 64, 40))), 16)
    ops.DISPATCH_RECORDS.clear()
    out = ops.packed_matmul_batched(torch.from_numpy(_x(rng, (2, 3, 64))),
                                    wp, 16, 40)
    assert out.shape == (2, 3, 40)
    assert [(r.op, r.path) for r in ops.DISPATCH_RECORDS] == [
        ("packed_matmul_batched", "fused_batched")]
    assert "packed_matmul_batched" in ops.launch_counts()


# ---------------------------------------------------------------------------
# (b) expert_linear, moe_ffn and moe_apply against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bank", ["w_in", "w_gate", "w_out"])
def test_expert_linear_matches_reference(R, trees, bank):
    ref_moe, port_moe = _layer0(R, trees)
    rw, pw = ref_moe["experts"][bank], port_moe["experts"][bank]
    assert is_packed(pw) and len(pw.logical_shape) == 3
    e, kdim, _ = pw.logical_shape
    x = _x(np.random.default_rng(2), (e, 3, kdim))
    want = np.asarray(R.L.expert_linear(R.jnp.asarray(x), rw))
    ops.DISPATCH_RECORDS.clear()
    got = L.expert_linear(torch.from_numpy(x), pw)
    assert ("packed_matmul_batched", "fused_batched") in {
        (r.op, r.path) for r in ops.DISPATCH_RECORDS}
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # a plain (unpacked) bank takes the einsum, as in the reference
    dense = pw.unpack()
    torch.testing.assert_close(L.expert_linear(torch.from_numpy(x), dense),
                               got, rtol=1e-5, atol=1e-5)


def _zero_router(R, ref_moe, port_moe):
    """Both sides' layer-0 MoE params with an all-zero packed router:
    every gate is 1/E, so top-k is decided by ties alone."""
    rz = dict(ref_moe, router=R.jax.tree_util.tree_map(R.jnp.zeros_like,
                                                       ref_moe["router"]))
    r = port_moe["router"]
    pz = dict(port_moe, router=PackedTensor(
        torch.zeros_like(r.data), r.bits, r.kind, r.signed,
        r.logical_shape, r.out_dtype))
    return rz, pz


def _routing(p, x, cfg):
    """(expert choice counts, capacity, choices) of ``blocks.route`` on
    x, the routing that ``moe_ffn`` runs."""
    _, top, cap = B.route(p, x.reshape(-1, x.shape[-1]), cfg)
    return torch.bincount(top.reshape(-1), minlength=cfg.n_experts), cap, top


@pytest.mark.parametrize("case", ["one_token", "drops", "ties"])
def test_moe_ffn_matches_reference(R, trees, rcfg, cfg, case):
    """``one_token``: cap 1, its two choices go to two experts, nothing
    drops. ``drops``: 3 tokens, cap 1, some expert is chosen twice and
    drops a token.
    ``ties``: a zero router, so all gates tie; the reference's top_k
    takes the lowest indices, and experts 0 and 1 overflow their
    capacity."""
    ref_moe, port_moe = _layer0(R, trees)
    if case == "ties":
        ref_moe, port_moe = _zero_router(R, ref_moe, port_moe)
    shape = {"one_token": (1, 1), "drops": (3, 1), "ties": (4, 2)}[case]
    x = _x(np.random.default_rng(3), shape + (cfg.d_model,))
    counts, cap, top = _routing(port_moe, torch.from_numpy(x), cfg)
    if case == "one_token":
        assert counts.max() <= cap
    else:
        assert counts.max() > cap
    if case == "ties":
        assert (top == torch.tensor([0, 1])).all()
    want = np.asarray(R.B.moe_ffn(ref_moe, R.jnp.asarray(x), rcfg))
    got = B.moe_ffn(port_moe, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@settings(max_examples=4, deadline=None, database=None)
@given(tokens=st.integers(1, 12), seed=st.integers(0, 2**16))
def test_moe_apply_matches_reference_property(R, trees, rcfg, cfg, tokens,
                                              seed):
    """moe_apply (norm, routed experts, shared experts, residual) over
    token counts whose capacity ranges from 1 to 4."""
    ref_moe, port_moe = _layer0(R, trees)
    x = _x(np.random.default_rng(seed), (tokens, 1, cfg.d_model))
    want = np.asarray(R.B.moe_apply(ref_moe, R.jnp.asarray(x), rcfg))
    got = B.moe_apply(port_moe, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_moe_apply_dense_residual_matches_reference(R):
    """arctic's MoE block adds a dense MLP in parallel with the experts
    (``dense_residual``): plain f32 weights, the reference's init."""
    rcfg = R.get_config("arctic_480b").reduced()
    cfg = get_config("arctic_480b").reduced()
    assert cfg.dense_residual
    ref_moe = R.jax.tree_util.tree_map(
        lambda a: a[0], R.LM(rcfg).init(R.prng_key(1))["blocks"]["moe"])
    port_moe = params_from_numpy(R.numpy_tree(ref_moe), device="cpu")
    assert set(port_moe) == set(B.init_moe(torch.Generator(), cfg, 1))
    x = _x(np.random.default_rng(7), (3, 1, cfg.d_model))
    want = np.asarray(R.B.moe_apply(ref_moe, R.jnp.asarray(x), rcfg))
    got = B.moe_apply(port_moe, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_unfusable_bank_materializes_on_cpu():
    """A packed bank no kernel takes (int kind) decodes in full on the
    CPU and leaves a fallback record."""
    gen = torch.Generator().manual_seed(4)
    w = torch.randint(-8, 8, (2, 32, 16), generator=gen, dtype=torch.int32)
    bank = pack_tensor(w, 8)
    x = torch.randn(2, 3, 32, generator=gen)
    ops.FALLBACK_RECORDS.clear()
    got = L.expert_linear(x, bank)
    torch.testing.assert_close(got, torch.bmm(x, w.float()))
    assert [(r.op, r.reason) for r in ops.FALLBACK_RECORDS] == [
        ("expert_linear", "not_fusable")]


# ---------------------------------------------------------------------------
# (c) engines: identical greedy tokens, decode logits within 1e-4
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_drain(R, rcfg):
    with mock.patch.object(R.engine_module, "repack", R.jitted_repack):
        eng = R.Engine(rcfg, max_seq_len=MAX_SEQ, max_slots=SLOTS,
                        pack_weights=True, prefill_chunk=CHUNK,
                        sample_seed=0)
    rids = [eng.submit(p, max_new_tokens=NEW) for p in _prompts()]
    stats = eng.run_until_drained()
    return {"engine": eng, "outs": [eng.result(r) for r in rids],
            "stats": stats, "params": R.numpy_tree(eng.params)}


@pytest.fixture(scope="module")
def port_drain(ref_drain, cfg):
    eng = ServeEngine(cfg, max_seq_len=MAX_SEQ, max_slots=SLOTS,
                      pack_weights=True, prefill_chunk=CHUNK,
                      params=params_from_numpy(ref_drain["params"], "cpu"),
                      device="cpu")
    ops.DISPATCH_RECORDS.clear()
    rids = [eng.submit(p, max_new_tokens=NEW) for p in _prompts()]
    stats = eng.run_until_drained()
    return {"engine": eng, "outs": [eng.result(r) for r in rids],
            "stats": stats, "records": list(ops.DISPATCH_RECORDS)}


def test_engine_greedy_tokens_identical(ref_drain, port_drain):
    assert all(o is not None and len(o) == NEW for o in ref_drain["outs"])
    assert port_drain["outs"] == ref_drain["outs"]
    for key in ("ticks", "decode_calls", "prefill_calls", "tokens",
                "fused_bytes_per_pass", "dense_bytes_per_pass",
                "kv_bytes_appended"):
        assert port_drain["stats"][key] == ref_drain["stats"][key], key


def test_engine_dispatches_every_kernel_op(port_drain):
    seen = {(r.op, r.path) for r in port_drain["records"]}
    for op_path in (("packed_matmul", "fused"),
                    ("packed_matmul_batched", "fused_batched"),
                    ("pack", "encode"), ("kv_decode", "kv_decode"),
                    ("take_rows", "take")):
        assert op_path in seen, op_path


def test_decode_step_logits_match(R, ref_drain, cfg):
    """Two decode steps from a fresh state: logits within atol 1e-4."""
    eng = ref_drain["engine"]
    lm = LM(cfg, device="cpu")
    params = params_from_numpy(ref_drain["params"], device="cpu")
    state = lm.init_decode_state(SLOTS, MAX_SEQ)
    ref_state = eng.lm.init_decode_state(SLOTS, MAX_SEQ)
    rng = np.random.default_rng(6)
    for _ in range(2):
        toks = rng.integers(0, cfg.vocab_size, (SLOTS, 1)).astype(np.int32)
        ref_logits, ref_state = eng._step(eng.params, ref_state,
                                          R.jnp.asarray(toks))
        logits, state = lm.decode_step(params, state, torch.from_numpy(toks))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# (e) plans, conversion and per-layer views
# ---------------------------------------------------------------------------

def test_uniform_plan_covers_stacked_banks_and_router(R, trees, cfg):
    """The port's plan over its own init names the reference's leaves
    (the stacked (L, E, K, N) banks and the f32 router included), and
    the engine packs them."""
    params = LM(cfg, device="cpu").init()
    plan = uniform_plan(params, 16)
    assert set(plan.float_bits) == set(
        R.uniform_plan(trees["ref_dense"], 16).float_bits)
    for key in ("blocks/moe/router", "blocks/moe/experts/w_in",
                "blocks/moe/experts/w_gate", "blocks/moe/experts/w_out"):
        assert plan.float_bits[key] == 16, key
    eng = ServeEngine(cfg, max_slots=1, max_seq_len=8, pack_weights=True,
                      params=params, device="cpu")
    moe = eng.params["blocks"]["moe"]
    for name in ("w_in", "w_gate", "w_out"):
        leaf = moe["experts"][name]
        assert is_packed(leaf) and leaf.logical_shape[:2] == (
            cfg.n_layers, cfg.n_experts)
    assert is_packed(moe["router"])
    assert moe["router"].out_dtype == torch.float32
    # the caller's tree is left as it was
    assert not is_packed(params["blocks"]["moe"]["experts"]["w_in"])


def test_repack_packs_in_place_through_dicts_lists_and_tuples():
    """``repack`` replaces each leaf of a dict or list in place (the
    dense leaf leaves the tree once its packed version exists), rebuilds
    tuples, passes through leaves the plan does not name, and returns
    the tree; the packed leaves equal ``pack_tensor``'s."""
    gen = torch.Generator().manual_seed(0)
    dense = [torch.randn((4, 40), generator=gen) for _ in range(4)]
    inner = [dense[1], {"b": dense[2]}]
    tree = {"a": dense[0], "l": inner, "t": (dense[3], torch.zeros(3)),
            "n": torch.zeros(5)}
    out = repack(tree, uniform_plan(tree, 16))
    assert out is tree and tree["l"] is inner
    got = [tree["a"], inner[0], inner[1]["b"], tree["t"][0]]
    for leaf, w in zip(got, dense):
        assert is_packed(leaf)
        assert torch.equal(leaf.data, pack_tensor(w, 16).data)
    assert not is_packed(tree["t"][1]) and not is_packed(tree["n"])


def test_interop_carries_the_moe_tree(trees):
    """Nested dicts of arrays and 4-D packed banks arrive bit for bit."""
    ref_moe = trees["ref"]["blocks"]["moe"]
    port_moe = trees["port"]["blocks"]["moe"]
    assert set(port_moe) == set(ref_moe)
    for name in ("w_in", "w_gate", "w_out"):
        r, p = ref_moe["experts"][name], port_moe["experts"][name]
        assert p.logical_shape == tuple(r.logical_shape) and p.bits == r.bits
        np.testing.assert_array_equal(p.data.numpy(),
                                      np.asarray(r.data).view(np.int32))
        assert p.out_dtype == torch.float32


def test_layer_params_slice_banks_and_decode_norms(trees, cfg):
    lm = LM(cfg, device="cpu")
    views = lm.layer_params(trees["port"])
    assert len(views) == cfg.n_layers
    moe = views[1]["moe"]
    bank = moe["experts"]["w_out"]
    assert is_packed(bank) and bank.logical_shape == (
        cfg.n_experts, cfg.moe_d_ff, cfg.d_model)
    stacked = trees["port"]["blocks"]["moe"]["experts"]["w_out"]
    assert torch.equal(bank.data, stacked.data[1])
    assert is_packed(moe["router"]) and len(moe["router"].logical_shape) == 2
    assert isinstance(moe["ln"], torch.Tensor) and moe["ln"].shape == (
        cfg.d_model,)
    assert lm.layer_params(trees["port"]) is views


# ---------------------------------------------------------------------------
# (d) on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card "
                    "(python -m pytest tests/test_torch_moe.py -k cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_cuda_unfusable_bank_raises(cuda):
    """On the card a packed bank no kernel takes (int kind, or a still
    stacked 4-D bank) is an error, not a full decode."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 3, 32, generator=gen).to(cuda)
    int_bank = pack_tensor(torch.randint(-8, 8, (2, 32, 16), generator=gen,
                                         dtype=torch.int32), 8)
    stacked = pack_tensor(torch.randn(2, 2, 32, 16, generator=gen), 16)
    ops.FALLBACK_RECORDS.clear()
    for bank in (int_bank, stacked):
        with pytest.raises(NotImplementedError, match="no kernel path"):
            L.expert_linear(x, bank.to(cuda))
    assert not ops.FALLBACK_RECORDS


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("bits", (8, 12, 16, 20, 24, 32))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_packed_matmul_batched(cuda, transpose, bits, dtype):
    """The kernel against its plain version: ragged shapes, one expert,
    a K split (small E), 40 rows an expert (the speculative verify's),
    and 64 experts of one row each (the full-size banks are checked by
    chip_smoke.py); then, made on the card, one expert at w_out's shape
    (a 3-way K split), two experts whose K split fills a cluster (8-way),
    and two whose K is past 8 slices of the transposed orientation's x
    buffer (odd K: slices in passes, x copied element by element); a
    misaligned bank raises."""
    rng = np.random.default_rng(600 + bits)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    for e, c, k, n in ((1, 1, 5, 7), (3, 2, 70, 37), (8, 3, 128, 64),
                       (2, 9, 300, 260), (2, 40, 500, 150),
                       (64, 1, 256, 160)):
        rows, cols = (n, k) if transpose else (k, n)
        w = (rng.standard_normal((e, rows, cols)) / np.sqrt(k)).astype(
            np.float32)
        wp = ref.pack_ref(torch.from_numpy(w), bits)
        x = torch.from_numpy(_x(rng, (e, c, k))).to(dtype)
        want = ref.packed_matmul_batched_ref(x, wp, bits, n, transpose)
        got = ops.packed_matmul_batched(x.to(cuda), wp.to(cuda), bits, n,
                                        transpose)
        assert got.dtype == dtype and got.shape == (e, c, n)
        torch.testing.assert_close(got.float().cpu(), want.to(dtype).float(),
                                   rtol=tol, atol=tol)
    gen = torch.Generator(device=cuda).manual_seed(600 + bits)
    for e, c, k, n in ((1, 8, 12288, 4096), (2, 3, 12288, 512),
                       (2, 40, 20001, 200)):
        x = torch.randn((e, c, k), generator=gen, device=cuda).to(dtype)
        w = torch.randn((e, n, k) if transpose else (e, k, n), generator=gen,
                        device=cuda) / np.sqrt(k)
        wp = ref.pack_ref(w, bits)
        want = ref.packed_matmul_batched_ref(x, wp, bits, n, transpose)
        got = ops.packed_matmul_batched(x, wp, bits, n, transpose)
        assert got.dtype == dtype and got.shape == (e, c, n)
        torch.testing.assert_close(got.float(), want.to(dtype).float(),
                                   rtol=tol, atol=tol)
    # a bank off the 16-byte grid is refused, in either orientation
    flat = torch.zeros(wp.numel() + 1, dtype=torch.int32, device=cuda)
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.packed_matmul_batched(x, flat[1:].view(wp.shape), bits, n,
                                  transpose)
    assert ops.launch_counts() == before


def test_cuda_moe_decode_step_matches_cpu(cuda, cfg):
    """Reduced deepseek decode_step on the card (kernels) against the CPU
    (plain versions), the same packed weights: logits within 1e-4, and
    the batched kernel launched three times per layer and step."""
    from repro_torch.core.tensor_store import tree_to
    lm_gpu, lm_cpu = LM(cfg, device=cuda), LM(cfg, device="cpu")
    params = lm_gpu.init()
    params = repack(params, uniform_plan(params, 16))
    params_cpu = tree_to(params, "cpu")
    st_g = lm_gpu.init_decode_state(SLOTS, 16)
    st_c = lm_cpu.init_decode_state(SLOTS, 16)
    rng = np.random.default_rng(0)
    ops.reset_launch_counts()
    for _ in range(3):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (SLOTS, 1)))
        lg, st_g = lm_gpu.decode_step(params, st_g, toks.to(cuda))
        lc, st_c = lm_cpu.decode_step(params_cpu, st_c, toks)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
    assert ops.launch_counts()["packed_matmul_batched"] == 3 * 3 * cfg.n_layers


def test_batched_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version (``ops`` sends CPU
    tensors to ``ref`` itself)."""
    from repro_torch.kernels import packed_matmul_batched as pmb
    before = ops.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        pmb.packed_matmul_batched(torch.zeros(2, 1, 32),
                                  torch.zeros(2, 32, 16, dtype=torch.int32),
                                  16, 32)
    assert ops.launch_counts() == before


def test_batched_split_plan_counts_experts():
    """The expert axis fills the grid: the full deepseek banks need no K
    split, a small bank splits K into 32-aligned slices covering K."""
    from repro_torch.kernels.packed_matmul import split_plan
    assert split_plan(1, 1408, 2048, 132, experts=64) == (1, 2048)
    assert split_plan(1, 2048, 1408, 132, experts=64) == (1, 1408)
    for e, m, n, k in ((8, 1, 64, 128), (2, 3, 7, 1000), (1, 1, 5, 5)):
        splits, chunk = split_plan(m, n, k, 132, experts=e)
        assert chunk % 32 == 0 and splits >= 1
        assert (splits - 1) * chunk < k <= splits * chunk or k <= chunk
