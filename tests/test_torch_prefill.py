"""``LM.prefill`` and ``LM.loss`` (forward) of the dense (qwen3-8b), moe
(deepseek-moe-16b) and vlm (paligemma-3b) families against the JAX
reference, on the CPU; and ``flash_attention``, ``attention_apply`` and
``moe_apply`` over a sequence alone.

Each family's reduced config (f32) is initialised by the reference,
packed at AF16 by the reference's own ``repack`` and carried across with
``repro_torch.interop`` (the same packed words); the reference runs as
its own tests run it (the ``auto`` backend: the jnp path on the CPU),
with one jit per family, shared by the module, that returns both its
``prefill`` logits and its ``loss`` (one compile instead of two). The
inputs come from a numpy seed. Held: the last-position logits within 1e-4, the loss within 1e-5 relative, blocks
within 1e-5 (f32; the two sides differ only in summation order). The
loss runs at T = 80 with s_chunk 32, so the reference's dropped tail (16
positions past the last whole chunk, still counted in the divisor)
shows; the vlm puts its 16 image tokens before the text; the MoE routes
t = B T tokens at a capacity factor of 1.0, so choices past an
expert's capacity are dropped. ``tests/test_torch_prefill_recurrent.py``
does the same for encdec, ssm and hybrid and shares these helpers.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import prng_key
from repro.core.compress import uniform_plan as ref_uniform_plan
from repro.models import attention as RA
from repro.models import blocks as RB
from repro.models.config import ALL_SHAPES as REF_SHAPES
from repro.models.lm import LM as RefLM

from repro_torch.interop import params_from_numpy
from repro_torch.models import attention as A
from repro_torch.models import blocks as B
from repro_torch.models.config import ALL_SHAPES
from repro_torch.models.lm import LM
from test_torch_families import BLOCK_TOL, configs, jitted, packed_block
from test_torch_serve import (_jitted_repack, _numpy_tree,  # noqa: F401
                              one_torch_thread)

LOGIT_TOL = 1e-4
LOSS_RTOL = 1e-5
BATCH, T, S_CHUNK = 2, 80, 32        # 80 = 2 chunks of 32 and a tail of 16
# the MoE at a capacity factor of 1.0: 160 tokens x 2 choices over 8
# experts is 40 rows an expert, which random routing overfills
OVERRIDES = {"deepseek_moe_16b": {"capacity_factor": 1.0}}
ARCHS = ("qwen3_8b", "deepseek_moe_16b", "paligemma_3b")


@functools.lru_cache(maxsize=None)
def model(arch):
    """The port's and the reference's LM on one set of AF16 packed
    weights, and the reference's jitted (prefill logits, loss)."""
    cfg, ref_cfg = configs(arch, **OVERRIDES.get(arch, {}))
    ref_lm = RefLM(ref_cfg)
    p = jax.jit(ref_lm.init)(prng_key(0))
    p = _jitted_repack(p, ref_uniform_plan(p, 16))
    return {"cfg": cfg, "lm": LM(cfg, device="cpu"), "ref_lm": ref_lm,
            "ref_params": p,
            "params": params_from_numpy(_numpy_tree(p), device="cpu"),
            "ref_run": jax.jit(lambda q, b: (
                ref_lm.prefill(q, b)[0], ref_lm.loss(q, b, s_chunk=S_CHUNK)))}


def reference(arch, batch):
    """The reference's (last-position logits, loss) of a numpy batch."""
    m = model(arch)
    logits, loss = m["ref_run"](m["ref_params"],
                                {k: jnp.asarray(v) for k, v in batch.items()})
    return np.asarray(logits), float(loss)


def make_batch(cfg, seed=0, t=T):
    """The reference's batch dict of numpy arrays (tokens, labels, the
    vlm's patch embeddings, encdec's frames)."""
    rng = np.random.default_rng(seed)
    batch = {name: rng.integers(0, cfg.vocab_size, (BATCH, t)).astype(
        np.int32) for name in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (BATCH, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def check_prefill(arch, seed=0, t=T):
    """Last-position logits of both sides within LOGIT_TOL; returns the
    port's."""
    m = model(arch)
    batch = make_batch(m["cfg"], seed, t)
    want = reference(arch, batch)[0]
    got, state = m["lm"].prefill(m["params"], port_batch(batch))
    assert state == {}
    assert tuple(got.shape) == (BATCH, 1, m["cfg"].vocab_size)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)
    return got


def check_loss(arch, seed=0):
    """The loss of both sides within LOSS_RTOL; labels in the dropped tail
    change neither side's value. Returns the port's."""
    m = model(arch)
    batch = make_batch(m["cfg"], seed)
    want = reference(arch, batch)[1]
    got = m["lm"].loss(m["params"], port_batch(batch), s_chunk=S_CHUNK)
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=LOSS_RTOL)
    tail = dict(batch, labels=batch["labels"].copy())
    tail["labels"][:, (T // S_CHUNK) * S_CHUNK:] = 0
    assert float(m["lm"].loss(m["params"], port_batch(tail),
                              s_chunk=S_CHUNK)) == float(got)
    assert reference(arch, tail)[1] == want
    return float(got)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match(arch):
    check_prefill(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_with_the_dropped_tail(arch):
    check_loss(arch)


def test_loss_counts_the_tail_in_its_divisor():
    """With s_chunk = T the loss is the mean over all B T positions; with
    s_chunk 32 it is the sum over the 64 whole-chunk positions over the
    same B T."""
    m = model("qwen3_8b")
    batch = port_batch(make_batch(m["cfg"], seed=3))
    lm, params = m["lm"], m["params"]
    h, _ = lm._forward(params, batch)
    logits = lm.logits_fn(params, h).float()
    nll = (torch.logsumexp(logits, -1)
           - logits.gather(-1, batch["labels"].long()[..., None])[..., 0])
    kept = (T // S_CHUNK) * S_CHUNK
    np.testing.assert_allclose(float(lm.loss(params, batch, s_chunk=T)),
                               float(nll.mean()), rtol=LOSS_RTOL)
    np.testing.assert_allclose(
        float(lm.loss(params, batch, s_chunk=S_CHUNK)),
        float(nll[:, :kept].sum() / (BATCH * T)), rtol=LOSS_RTOL)


def test_vlm_image_prefix_enters_and_attends_causally():
    """The image prefix reaches the logits, and (the reference's
    behaviour: ``attention_apply`` does not pass ``prefix`` on) its
    tokens attend causally: the hidden state at image position 0 does
    not depend on later image tokens."""
    m = model("paligemma_3b")
    cfg, lm, params = m["cfg"], m["lm"], m["params"]
    batch = make_batch(cfg, seed=4)
    base = check_prefill("paligemma_3b", seed=4)
    other = dict(batch, patch_embeds=batch["patch_embeds"].copy())
    other["patch_embeds"][:, 1:] *= -1.0
    assert not torch.allclose(lm.prefill(params, port_batch(other))[0], base)
    h1, prefix = lm._forward(params, port_batch(batch))
    h2, _ = lm._forward(params, port_batch(other))
    assert prefix == cfg.num_image_tokens
    assert h1.shape[1] == cfg.num_image_tokens + T
    torch.testing.assert_close(h1[:, 0], h2[:, 0], rtol=0, atol=0)


def test_moe_capacity_at_t_tokens_drops_choices():
    """The router sees the B T tokens of the batch at once, its capacity
    is ``blocks.capacity`` of B T, and choices past it are dropped: some
    expert is asked for more rows than it has."""
    m = model("deepseek_moe_16b")
    cfg = m["cfg"]
    seen = []
    route = B.route

    def recording(p, xf, c):
        out = route(p, xf, c)
        seen.append((xf.shape[0], out[1], out[2]))
        return out

    B.route = recording
    try:
        check_prefill("deepseek_moe_16b", seed=5)
    finally:
        B.route = route
    assert len(seen) == cfg.n_layers
    for t, top_i, cap in seen:
        assert t == BATCH * T and cap == B.capacity(cfg, BATCH * T) == 40
        load = torch.bincount(top_i.reshape(-1), minlength=cfg.n_experts)
        assert int(load.max()) > cap


def test_moe_apply_over_a_sequence_matches_reference():
    pc, cfg = configs("deepseek_moe_16b", capacity_factor=1.0)
    p, pp = packed_block(RB.init_moe, cfg)
    x = np.random.default_rng(6).standard_normal(
        (BATCH, 24, cfg.d_model)).astype(np.float32)
    want = jitted(RB.moe_apply, cfg=cfg)(p, jnp.asarray(x))
    got = B.moe_apply(pp, torch.from_numpy(x), pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BLOCK_TOL)


@pytest.mark.parametrize("arch,prefix", [("qwen3_8b", 0),
                                         ("paligemma_3b", 5)])
def test_attention_apply_matches_reference(arch, prefix):
    """Causal self-attention over a sequence: qwen3's qk_norm and GQA,
    paligemma's MQA at head_dim 32 with a ``prefix`` that both sides
    ignore; rope from the positions."""
    pc, cfg = configs(arch)
    p, pp = packed_block(RB.init_attention, cfg)
    s = 40
    x = np.random.default_rng(7).standard_normal(
        (BATCH, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (BATCH, s))
    want = jitted(RB.attention_apply, cfg=cfg, prefix=prefix)(
        p, jnp.asarray(x), positions=jnp.asarray(pos))
    got = B.attention_apply(pp, torch.from_numpy(x), pc,
                            torch.from_numpy(pos.copy()), prefix=prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BLOCK_TOL)


# (Sq, Sk, H, Hkv, causal, window): 60 rows cut into q chunks of 15 and
# kv chunks of 20 (``_divisor_chunk`` of the targets 16 and 25); a window
# of 7 masks whole kv chunks, one of 30 spans two
FLASH_CASES = {
    "causal": (60, 60, 4, 2, True, 0),
    "window": (60, 60, 4, 1, True, 7),
    "full": (60, 60, 6, 2, False, 0),
    "wide_window": (60, 60, 4, 4, True, 30),
    "cross": (12, 60, 4, 2, False, 0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_reference(case, dtype):
    """f32 within 1e-5; bf16 operands (exact in the f32 logits, the
    weights rounded to bf16 against v as in the reference) within one
    bf16 rounding of the output (2^-8 relative), the two sides' f32
    sums running in another order."""
    sq, sk, h, hkv, causal, window = FLASH_CASES[case]
    rng = np.random.default_rng(8)
    q, k, v = (rng.standard_normal((BATCH, n, heads, 16)).astype(np.float32)
               for n, heads in ((sq, h), (sk, hkv), (sk, hkv)))
    kw = dict(causal=causal, window=window, q_chunk=16, kv_chunk=25)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(RA.flash_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), **kw)
        .astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = A.flash_attention(*(torch.from_numpy(a).to(tdt)
                              for a in (q, k, v)), **kw)
    assert got.dtype == tdt and tuple(got.shape) == (BATCH, sq, h, 16)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BLOCK_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8,
                                   atol=2.0 ** -8 * np.abs(want).max())
    # the chunking changes the order of summation only
    whole = A.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, window=window)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=0,
                                   atol=BLOCK_TOL)


def test_chunk_mask_matches_reference():
    qp, kp = np.arange(3, 13), np.arange(0, 16)
    for causal, window in ((True, 0), (True, 4), (False, 5), (False, 0)):
        want = np.asarray(RA._chunk_mask(jnp.asarray(qp), jnp.asarray(kp),
                                         causal, window))
        got = A._chunk_mask(torch.from_numpy(qp), torch.from_numpy(kp),
                            causal, window)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ("qwen3_8b", "deepseek_moe_16b",
                                  "paligemma_3b", "whisper_small",
                                  "falcon_mamba_7b", "recurrentgemma_9b"))
def test_input_specs_match_reference(arch):
    """The (shape, dtype) of every input of every shape cell, without
    allocating."""
    cfg, ref_cfg = configs(arch)
    lm, ref_lm = LM(cfg, device="cpu"), RefLM(ref_cfg)
    for shape, ref_shape in zip(ALL_SHAPES, REF_SHAPES):
        assert dataclasses.astuple(shape) == dataclasses.astuple(ref_shape)
        want = {k: (tuple(s.shape), jnp.dtype(s.dtype).name)
                for k, s in ref_lm.input_specs(ref_shape).items()}
        got = {k: (s, str(dt).split(".")[-1])
               for k, (s, dt) in lm.input_specs(shape).items()}
        assert got == want
