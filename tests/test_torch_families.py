"""The vlm (paligemma-3b) and encdec (whisper-small) serving paths
against the JAX reference, on the CPU.

One reference ``ServeEngine`` per family (reduced config, AF16 packed
weights and AF16 packed KV, 2 slots, more requests than slots) is built
and drained once per module; its packed parameters are carried across
with ``repro_torch.interop`` (the same packed words), and the port's
engines, on ``device="cpu"`` (the plain versions of the kernels), drain
the same requests: dense, paged (the reference holds its paged tokens
to its dense ones, so both are held to its dense drain) and speculative
(greedy: the plain drain's tokens). Decode logits are held within 1e-4
per call (f32; the two sides differ in summation order) from the same
state, for encdec also over a nonzero cross cache made from a seed (the
engine's all-zero cache cannot catch a cross-path fault). The
cross-attention block is held within 1e-5. ``tests/
test_torch_recurrent.py`` does the same for ssm and hybrid and shares
these helpers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as ref_engine_module
from repro.compat import prng_key
from repro.configs import get_config as ref_get_config
from repro.core.compress import uniform_plan as ref_uniform_plan
from repro.models import blocks as RB
from repro.serving import ServeEngine as RefEngine

from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, tensor_from_numpy
from repro_torch.kernels import ref as kref
from repro_torch.models import blocks as B
from repro_torch.models.lm import LM
from repro_torch.serving import ServeEngine, SpeculativeEngine
from test_torch_serve import (_jitted_repack, _numpy_tree,  # noqa: F401
                              one_torch_thread)

SLOTS, MAX_SEQ, CHUNK, NEW, PAGE = 2, 24, 4, 3, 8
# more requests than slots, an empty prompt, prompts past the prefill
# chunk; every remainder keeps to the one chunk bucket of 4, so the
# reference compiles one prefill program
PROMPT_LENS = (5, 0, 9, 1)
ENGINE_KW = dict(max_seq_len=MAX_SEQ, max_slots=SLOTS, pack_weights=True,
                 prefill_chunk=CHUNK)
LOGIT_TOL = 1e-4
BLOCK_TOL = 1e-5


def make_prompts(lens, vocab=512):
    rng = np.random.default_rng(11)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lens]


def drain(eng, prompts):
    rids = [eng.submit(p, max_new_tokens=NEW) for p in prompts]
    stats = eng.run_until_drained()
    return [eng.result(r) for r in rids], stats


# served at their own size: paper_native is a CPU-sized stand-in already
# (2 layers, d_model 256)
OWN_SIZE = ("paper_native",)


def configs(arch, **overrides):
    """(port, reference) reduced configs of ``arch`` (``OWN_SIZE`` ones
    as published), with ``overrides``."""
    return tuple(dataclasses.replace(
        get(arch) if arch in OWN_SIZE else get(arch).reduced(), **overrides)
        for get in (get_config, ref_get_config))


@functools.lru_cache(maxsize=None)
def _reference_run(arch, lens, overrides, engine_kw):
    _, cfg = configs(arch, **dict(overrides))
    with mock.patch.object(ref_engine_module, "repack", _jitted_repack):
        eng = RefEngine(cfg, sample_seed=0, **dict(ENGINE_KW, **dict(
            engine_kw)))
    outs, stats = drain(eng, make_prompts(lens))
    assert all(o is not None and len(o) == NEW for o in outs)
    return {"arch": arch, "overrides": dict(overrides), "engine": eng,
            "engine_kw": dict(engine_kw), "outs": outs, "stats": stats,
            "params": _numpy_tree(eng.params), "lens": lens}


def reference_run(arch, lens=PROMPT_LENS, engine_kw=(), **overrides):
    """The reference engine built and drained once per process and
    arguments (``engine_kw``: (name, value) pairs over ``ENGINE_KW``):
    its engine, outputs, stats and packed parameters in interop's numpy
    form."""
    return _reference_run(arch, tuple(lens), tuple(sorted(overrides.items())),
                          tuple(engine_kw))


def port_engine(run, cls=ServeEngine, **kw):
    cfg, _ = configs(run["arch"], **run["overrides"])
    return cls(cfg, params=params_from_numpy(run["params"], device="cpu"),
               device="cpu", **dict(ENGINE_KW, **run["engine_kw"], **kw))


def port_run(run, cls=ServeEngine, **kw):
    eng = port_engine(run, cls, **kw)
    outs, stats = drain(eng, make_prompts(run["lens"]))
    return {"engine": eng, "outs": outs, "stats": stats}


def check_counters(run, port):
    for key in ("tokens", "ticks", "decode_calls", "prefill_calls",
                "weight_passes", "kv_rows_appended", "fused_bytes_per_pass",
                "fused_analytic_bytes_per_pass", "dense_bytes_per_pass",
                "weight_read_bytes_fused", "kv_bytes_appended"):
        assert port["stats"][key] == run["stats"][key], key


def to_jax(t: torch.Tensor):
    """A port tensor as the reference's array (int32 words as uint32)."""
    a = t.numpy()
    return jnp.asarray(a.view(np.uint32) if a.dtype == np.int32 else a)


def port_state(ref_state):
    """A copy of the reference's decode state as the port's tensors."""
    return jax.tree_util.tree_map(
        lambda a: tensor_from_numpy(np.array(a), torch.device("cpu")),
        ref_state)


@contextlib.contextmanager
def reference_rows(ref_kv):
    """Inside, the port's dense KV append (``blocks.update_kv_cache``)
    writes the reference's words of each row it appends (the layers in
    call order index ``ref_kv``, the state after the reference's call)
    over its own, so that a code the two sides round apart (their f32
    sums run in another order) is not read by the rest of the call.
    Yields the list of (own words, reference words) per layer, K and
    V (a plain cache's rows as they are)."""
    want = {n: tensor_from_numpy(np.array(ref_kv[n]), torch.device("cpu"))
            for n in ("k", "v")}
    append, rows = B.update_kv_cache, []

    def update(kc, vc, k_new, v_new, kv_len, kv_bits):
        append(kc, vc, k_new, v_new, kv_len, kv_bits)
        layer = len(rows) // 2
        b = torch.arange(kc.shape[0])
        pos = kv_len.long().clamp(0, kc.shape[1] - 1)
        for cache, name in ((kc, "k"), (vc, "v")):
            ref_row = want[name][layer][b, pos]
            rows.append((cache[b, pos].clone(), ref_row))
            cache[b, pos] = ref_row
        return kc, vc

    with mock.patch.object(B, "update_kv_cache", update):
        yield rows


def check_rows(rows, d, bits=16):
    """Appended rows of the two sides decode within one code step, or
    within 2^-16 (the f32 projections' summation order, for a value that
    cancellation left small); plain rows (``bits`` None) within 1e-5."""
    if bits is None:
        for own, theirs in rows:
            np.testing.assert_allclose(own.numpy(), theirs.numpy(),
                                       rtol=1e-5, atol=1e-5)
        return
    step = 2.0 ** -{16: 10, 12: 7}[bits]
    for own, theirs in rows:
        np.testing.assert_allclose(kref.unpack_ref(own, bits, d).numpy(),
                                   kref.unpack_ref(theirs, bits, d).numpy(),
                                   rtol=step, atol=2.0 ** -16)


def decode_steps(run, steps, setup=None, seed=5):
    """``steps`` decode calls of random tokens, each from the reference's
    state (fresh, then ``setup(ref_state, port_state)``, which fills the
    same values into both, then the reference's state after the call
    before): logits within LOGIT_TOL per call, with the reference's
    appended KV words (``reference_rows``; each the port's own within a
    code step), and every word of the port's cache then the
    reference's. Returns the two states after the last call."""
    eng = run["engine"]
    cfg, _ = configs(run["arch"], **run["overrides"])
    lm = LM(cfg, device="cpu")
    params = params_from_numpy(run["params"], device="cpu")
    ref_state = eng.lm.init_decode_state(SLOTS, MAX_SEQ)
    state = lm.init_decode_state(SLOTS, MAX_SEQ)
    assert (jax.tree_util.tree_structure(ref_state)
            == jax.tree_util.tree_structure(state))
    if setup is not None:
        ref_state = setup(ref_state, state)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        toks = rng.integers(0, cfg.vocab_size, (SLOTS, 1)).astype(np.int32)
        state = port_state(ref_state)
        ref_logits, ref_state = eng._step(eng.params, ref_state,
                                          jnp.asarray(toks))
        ref_kv = ref_state.get("kv", {"k": np.zeros(0), "v": np.zeros(0)})
        with reference_rows(ref_kv) as rows:
            logits, state = lm.decode_step(params, state,
                                           torch.from_numpy(toks))
        check_rows(rows, cfg.resolved_head_dim, cfg.compression.kv_bits)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   rtol=0, atol=LOGIT_TOL)
        if "kv" in state:
            for name in ("k", "v"):
                np.testing.assert_array_equal(
                    state["kv"][name].numpy(),
                    tensor_from_numpy(np.array(ref_kv[name]),
                                      torch.device("cpu")).numpy())
    np.testing.assert_array_equal(state["len"].numpy(),
                                  np.asarray(ref_state["len"]))
    return ref_state, state


def packed_block(init_fn, cfg):
    """One layer's reference parameters from ``init_fn`` packed at AF16
    by the reference, and the port's copy of the same words."""
    p = init_fn(prng_key(3), cfg)
    p = _jitted_repack(p, ref_uniform_plan(p, 16))
    return p, params_from_numpy(_numpy_tree(p), device="cpu")


def jitted(block, **static):
    """A reference block jitted with its config and flags fixed (its
    packed linears are slow op by op)."""
    return jax.jit(functools.partial(block, **static))


def random_words(shape, d, seed, bits=16):
    """Packed words of random values, (..., Hkv, ceil(d/32)*bits)."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape + (d,)).astype(np.float32))
    return kref.pack_ref(x, bits)


# ---------------------------------------------------------------------------
# vlm and encdec engines against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["paligemma_3b", "whisper_small"])
def fam(request):
    return reference_run(request.param)


@pytest.fixture(scope="module")
def dense(fam):
    return port_run(fam)


def test_greedy_tokens_identical(fam, dense):
    assert dense["outs"] == fam["outs"]
    check_counters(fam, dense)


def test_paged_tokens_identical(fam):
    paged = port_run(fam, paged=True, kv_page_size=PAGE)
    assert paged["outs"] == fam["outs"]
    assert paged["stats"]["prefill_calls"] == fam["stats"]["prefill_calls"]
    assert not (paged["stats"]["pool_pages_used"]
                or paged["stats"]["pool_pages_reserved"])


@pytest.mark.parametrize("paged", [False, True])
def test_speculative_greedy_gives_plain_tokens(fam, paged):
    spec = port_run(fam, SpeculativeEngine, k=2, paged=paged,
                    kv_page_size=PAGE)
    assert spec["outs"] == fam["outs"]
    assert spec["stats"]["spec_ticks"] > 0


def test_decode_step_logits_match(fam):
    decode_steps(fam, 3)


def test_encdec_state_and_clen(fam, dense):
    eng = dense["engine"]
    cfg = eng.cfg
    if cfg.family != "encdec":
        assert "cross" not in eng.state and "clen" not in eng.state
        return
    ref_state = fam["engine"].state
    assert eng.state["clen"].tolist() == [cfg.encoder_seq] * SLOTS
    np.testing.assert_array_equal(eng.state["clen"].numpy(),
                                  np.asarray(ref_state["clen"]))
    for name in ("ck", "cv"):
        assert tuple(eng.state["cross"][name].shape) == tuple(
            ref_state["cross"][name].shape)
    paged = port_engine(fam, paged=True, kv_page_size=PAGE)
    assert paged.state["cross"]["ck"].shape == eng.state["cross"]["ck"].shape
    assert paged.state["clen"].tolist() == [cfg.encoder_seq] * SLOTS


def test_encdec_decode_over_a_nonzero_cross_cache():
    """Cross K/V of random values (numpy seed) and per-slot ``clen``
    below the cache length, the same words on both sides."""
    run = reference_run("whisper_small")
    cfg, _ = configs("whisper_small")
    d = cfg.resolved_head_dim

    def setup(ref_state, state):
        clen = torch.tensor([cfg.encoder_seq, 7], dtype=torch.int32)
        state["clen"] = clen
        for i, name in enumerate(("ck", "cv")):
            shape = tuple(state["cross"][name].shape[:-1])
            state["cross"][name].copy_(random_words(shape, d, seed=20 + i))
        return dict(ref_state, clen=jnp.asarray(clen.numpy()),
                    cross={n: to_jax(state["cross"][n]) for n in ("ck", "cv")})

    ref_state, state = decode_steps(run, 3, setup, seed=6)
    # the cross cache is read, never written
    np.testing.assert_array_equal(state["cross"]["ck"].numpy().view(np.uint32),
                                  np.asarray(ref_state["cross"]["ck"]))


def test_cross_attention_block_matches_reference():
    """``attention_decode(cross=True)``: q alone, no rope, over ``clen``
    rows of a packed cross cache; the cache is returned as it was."""
    pc, cfg = configs("whisper_small")
    p, pp = packed_block(RB.init_attention, cfg)
    b, s, d = 3, cfg.encoder_seq, cfg.resolved_head_dim
    rng = np.random.default_rng(8)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    ck = random_words((b, s, cfg.n_kv_heads), d, seed=30)
    cv = random_words((b, s, cfg.n_kv_heads), d, seed=31)
    clen = np.array([s, 1, 13], np.int32)
    want, ref_st = jitted(RB.attention_decode, cfg=cfg, cross=True)(
        p, jnp.asarray(x), state={"ck": to_jax(ck), "cv": to_jax(cv),
                                  "clen": jnp.asarray(clen)},
        positions=jnp.zeros((b, 1), jnp.int32))
    st = {"ck": ck, "cv": cv, "clen": torch.from_numpy(clen)}
    got, st2 = B.attention_decode(pp, torch.from_numpy(x), pc, st, None,
                                  kv_bits=16, cross=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BLOCK_TOL)
    assert st2["ck"] is ck and st2["cv"] is cv


def check_init_tree(run):
    """``LM.init`` makes the reference's tree: the same leaves at the
    same shapes and dtypes (encdec's encoder and hybrid's nested stacks
    and tail included), so ``uniform_plan`` packs the same leaves and
    the byte counts agree."""
    cfg, _ = configs(run["arch"], **run["overrides"])
    trees = (LM(cfg, device="cpu").init(),
             jax.eval_shape(lambda: run["engine"].lm.init(prng_key(0))))
    ours, theirs = ({tuple(k.key for k in path):
                     (tuple(leaf.shape), str(leaf.dtype).split(".")[-1])
                     for path, leaf in jax.tree_util.tree_flatten_with_path(
                         tree)[0]} for tree in trees)
    assert ours == theirs


def test_init_tree_matches_reference(fam):
    check_init_tree(fam)
