"""``LM.prefill`` and ``LM.loss`` (forward) of the encdec (whisper-small),
ssm (falcon-mamba-7b) and hybrid (recurrentgemma-9b) families against
the JAX reference, on the CPU; and ``_causal_conv``, ``mamba_apply``,
``rglru_apply``, cross attention over a sequence and whisper's encoder
alone.

The set-up and tolerances are ``tests/test_torch_prefill.py``'s (its
helpers, one jit of the reference's prefill and loss per family):
last-position logits within 1e-4, the loss within 1e-5 relative, blocks
within 1e-5. T = 80 with s_chunk 32, so the loss drops
a tail of 16 positions; the hybrid's reduced window is 64, so at T = 80
its local attention masks; whisper's encoder runs over 32 frames.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as RB

from repro_torch.models import blocks as B
from test_torch_families import BLOCK_TOL, configs, jitted, packed_block
from test_torch_prefill import (BATCH, T, check_loss,  # noqa: F401
                                check_prefill, make_batch, model,
                                one_torch_thread)

ARCHS = ("whisper_small", "falcon_mamba_7b", "recurrentgemma_9b")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match(arch):
    check_prefill(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_with_the_dropped_tail(arch):
    check_loss(arch)


def test_hybrid_window_masks_at_t_80():
    """The hybrid's local attention over 80 positions, past its reduced
    window of 64: the block matches the reference, and differs from the
    same block without a window, so the mask acted."""
    pc, cfg = configs("recurrentgemma_9b")
    assert cfg.attn_window == 64 < T
    p, pp = packed_block(RB.init_attention, cfg)
    x = np.random.default_rng(9).standard_normal(
        (BATCH, T, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (BATCH, T)).copy()
    want = jitted(RB.attention_apply, cfg=cfg, window=cfg.attn_window)(
        p, jnp.asarray(x), positions=jnp.asarray(pos))
    args = (pp, torch.from_numpy(x), pc, torch.from_numpy(pos))
    got = B.attention_apply(*args, window=pc.attn_window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BLOCK_TOL)
    full = B.attention_apply(*args)
    torch.testing.assert_close(got[:, :64], full[:, :64], rtol=0,
                               atol=BLOCK_TOL)
    assert (got[:, 64:] - full[:, 64:]).abs().max() > 1e-3


def test_whisper_encoder_matches_reference():
    """``_encode``: roped, non-causal self-attention and an MLP per
    layer over the frames, then ``enc_norm``."""
    m = model("whisper_small")
    frames = make_batch(m["cfg"], seed=10)["frames"]
    want = jitted(m["ref_lm"]._encode)(m["ref_params"], jnp.asarray(frames))
    got = m["lm"]._encode(m["params"], torch.from_numpy(frames))
    assert tuple(got.shape) == (BATCH, m["cfg"].encoder_seq,
                                m["cfg"].d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BLOCK_TOL)


def test_cross_attention_apply_matches_reference():
    """Cross attention over an encoder output: no rope, not causal, the
    keys and values projected from ``kv_source`` as it is."""
    pc, cfg = configs("whisper_small")
    p, pp = packed_block(RB.init_attention, cfg)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((BATCH, 20, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((BATCH, cfg.encoder_seq,
                               cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20, dtype=np.int32), (BATCH, 20)).copy()
    want = jitted(RB.attention_apply, cfg=cfg, use_rope=False)(
        p, jnp.asarray(x), positions=jnp.asarray(pos),
        kv_source=jnp.asarray(enc))
    got = B.attention_apply(pp, torch.from_numpy(x), pc,
                            torch.from_numpy(pos), kv_source=torch.from_numpy(
                                enc), use_rope=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BLOCK_TOL)


@pytest.mark.parametrize("width", [1, 4])
def test_causal_conv_matches_reference(width):
    rng = np.random.default_rng(12 + width)
    x = rng.standard_normal((BATCH, 9, 24)).astype(np.float32)
    w = rng.standard_normal((24, width)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    want = RB._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           width)
    got = B._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b), width)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BLOCK_TOL)


@pytest.mark.parametrize("s", [5, 300])
def test_mamba_apply_matches_reference(s):
    """Mamba over a sequence from a zero state; at S = 300 the port makes
    its scan factors in two chunks (SCAN_CHUNK 256)."""
    pc, cfg = configs("falcon_mamba_7b")
    p, pp = packed_block(RB.init_mamba, cfg)
    x = np.random.default_rng(14).standard_normal(
        (BATCH, s, cfg.d_model)).astype(np.float32)
    want = jitted(RB.mamba_apply, cfg=cfg)(p, jnp.asarray(x))
    got = B.mamba_apply(pp, torch.from_numpy(x), pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BLOCK_TOL)


def test_rglru_apply_matches_reference():
    pc, cfg = configs("recurrentgemma_9b")
    p, pp = packed_block(RB.init_rglru, cfg)
    x = np.random.default_rng(15).standard_normal(
        (BATCH, 33, cfg.d_model)).astype(np.float32)
    want = jitted(RB.rglru_apply, cfg=cfg)(p, jnp.asarray(x))
    got = B.rglru_apply(pp, torch.from_numpy(x), pc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BLOCK_TOL)
