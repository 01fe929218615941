"""The training half of the port's layers, its optimizer, error
feedback, data stream and watchdog against the JAX reference, on the
CPU.

Straight-through weights (``STWeight``: codes plus a dense master) are
built by the reference's ``pack_tensor`` and carried across bit for
bit; inputs come from a numpy seed. The gradients of every packed
product (``st_linear`` in both orientations at AF8/12/16, ``unembed``
tied and untied, the batched ``expert_linear``, ``_FusedMM``'s dx, the
embedding's scatter, a norm scale's straight-through decode) are held to
``jax.grad`` of the reference within 1e-5 (f32; the sides differ in
summation order only), and the fused paths to the port's own
``fallback=True`` oracle. AdamW's masters agree within 1e-6 and its
packed moments within one code step; the re-encode, the staleness
probe and the error feedback are bit for bit.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.tensor_store import STWeight as RefST
from repro.core.tensor_store import pack_tensor as ref_pack_tensor
from repro.data import SyntheticTokens as RefTokens
from repro.distributed.grad_compress import \
    apply_error_feedback as ref_apply_ef
from repro.kernels import ref as RR
from repro.models import layers as RL
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import packed_staleness as ref_staleness
from repro.optim import repack_params as ref_repack_params

from repro_torch.core import bitpack
from repro_torch.core.formats import FLOAT_FORMATS
from repro_torch.core.tensor_store import STWeight, is_packed, pack_tensor
from repro_torch.data import SyntheticTokens
from repro_torch.distributed.grad_compress import (apply_error_feedback,
                                                   init_error_feedback)
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import ref as kref
from repro_torch.models import layers as L
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, packed_staleness,
                               repack_params, row_chunks)
from repro_torch.train.loop import TrainConfig, _grad_loop
from repro_torch.train.watchdog import PreemptionGuard, StragglerWatchdog
from test_torch_serve import _numpy_tree, one_torch_thread  # noqa: F401

TOL = 1e-5


def port_of(tree):
    """The port's copy of a reference tree (arrays, PackedTensors and
    STWeights), the same bits."""
    if isinstance(tree, RefST):
        return STWeight(port_of(tree.packed), port_of(tree.master))
    if isinstance(tree, dict):
        return {k: port_of(v) for k, v in tree.items()}
    return params_from_numpy(_numpy_tree(tree), device="cpu")


def pair(rng, shape, bits=16):
    """A reference STWeight of random f32 values packed at ``bits``, and
    the port's."""
    w = jnp.asarray((rng.standard_normal(shape) * 0.3).astype(np.float32))
    ref = RefST(ref_pack_tensor(w, bits), w)
    return ref, port_of(ref)


def grads_of(fn, *args):
    """(value, grads) of sum(fn(*args) * R) for a fixed random R, in
    the port, w.r.t. every tensor argument."""
    args = [a.detach().requires_grad_(True) for a in args]
    out = fn(*args)
    r = torch.from_numpy(np.random.default_rng(99).standard_normal(
        tuple(out.shape)).astype(np.float32))
    gs = torch.autograd.grad((out * r).sum(), args)
    return out.detach().numpy(), [g.numpy() for g in gs]


def ref_grads_of(fn, *args):
    """The same for the reference, with ``jax.grad``, in one jit (the
    packed layers are slow op by op)."""
    r = jnp.asarray(np.random.default_rng(99).standard_normal(
        jax.eval_shape(fn, *args).shape).astype(np.float32))
    argnums = tuple(range(len(args)))

    def run(*a):
        return fn(*a), jax.grad(lambda *b: (fn(*b) * r).sum(),
                                argnums=argnums)(*a)

    out, gs = jax.jit(run)(*args)
    return np.asarray(out), [np.asarray(g) for g in gs]


def assert_close(got, want, tol=TOL):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


def x_of(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


# ---------------------------------------------------------------------------
# the packed products' gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("bits", [8, 12, 16])
def test_st_linear_grads_match_reference(bits, transpose):
    """dx (through the kernel, flipped) and dW (from residuals) of
    ``st_linear`` against jax.grad of the reference's, and against the
    port's materialized ``fallback=True``; the forward is the bare
    packed weight's, bit for bit."""
    rng = np.random.default_rng(bits + transpose)
    ref, port = pair(rng, (96, 64) if transpose else (64, 96), bits)
    xj, xt = x_of(rng, (2, 3, 64))
    want = ref_grads_of(lambda x, m: RL.st_linear(
        x, ref.packed, m, transpose=transpose), xj, ref.master)
    got = grads_of(lambda x, m: L.st_linear(
        x, port.packed, m, transpose=transpose), xt, port.master)
    oracle = grads_of(lambda x, m: L.st_linear(
        x, port.packed, m, transpose=transpose, fallback=True),
        xt, port.master)
    assert_close([got[0]] + got[1], [want[0]] + want[1])
    assert_close([got[0]] + got[1], [oracle[0]] + oracle[1])
    bare = L._packed_matmul(xt, port.packed, transpose).numpy()
    np.testing.assert_array_equal(got[0], bare)
    assert np.abs(got[1][1]).max() > 0


def test_fused_mm_dx_through_a_packed_weight():
    """A bare PackedTensor (no master): dx flows through ``linear`` and
    the tied ``unembed`` (the kernel's two orientations flipped); the
    words stay without a gradient."""
    rng = np.random.default_rng(5)
    for tied, shape in ((False, (64, 96)), (True, (96, 64))):
        ref, port = pair(rng, shape)
        xj, xt = x_of(rng, (4, 64))
        if tied:
            fn_r = lambda x: RL.unembed(x, ref.packed, tied=True)  # noqa: E731
            fn_p = lambda x: L.unembed(x, port.packed, tied=True)  # noqa: E731
        else:
            fn_r = lambda x: RL.linear(x, ref.packed)  # noqa: E731
            fn_p = lambda x: L.linear(x, port.packed)  # noqa: E731
        want = ref_grads_of(fn_r, xj)
        got = grads_of(fn_p, xt)
        assert_close([got[0]] + got[1], [want[0]] + want[1])
        assert not port.packed.data.requires_grad


def test_st_unembed_both_orientations():
    rng = np.random.default_rng(1)
    xj, xt = x_of(rng, (3, 64))
    for tied, shape in ((True, (96, 64)), (False, (64, 96))):
        ref, port = pair(rng, shape)
        want = ref_grads_of(lambda x, m: RL.unembed(
            x, RefST(ref.packed, m), tied=tied), xj, ref.master)
        got = grads_of(lambda x, m: L.unembed(
            x, STWeight(port.packed, m), tied=tied), xt, port.master)
        assert_close([got[0]] + got[1], [want[0]] + want[1])
        oracle = grads_of(lambda x, m: L.st_linear(
            x, port.packed, m, transpose=tied, fallback=True),
            xt, port.master)
        assert_close(got[1], oracle[1])


def test_st_expert_linear_batched_grads():
    """The batched ST form: dx[e] through the bank's transposed
    orientation, dW[e] per expert from the residuals."""
    rng = np.random.default_rng(2)
    ref, port = pair(rng, (3, 64, 96))
    xj, xt = x_of(rng, (3, 5, 64))
    want = ref_grads_of(lambda x, m: RL.expert_linear(
        x, RefST(ref.packed, m)), xj, ref.master)
    got = grads_of(lambda x, m: L.expert_linear(
        x, STWeight(port.packed, m)), xt, port.master)
    assert_close([got[0]] + got[1], [want[0]] + want[1])
    bare = grads_of(lambda x: L.expert_linear(x, port.packed), xt)
    assert_close(bare[1], got[1][:1])


def test_st_embed_scatters_into_the_gathered_rows():
    rng = np.random.default_rng(3)
    ref, port = pair(rng, (32, 64))
    toks = np.asarray([[3, 3, 7], [0, 31, 7]], np.int32)
    want = ref_grads_of(lambda m: RL.embed(jnp.asarray(toks),
                                           RefST(ref.packed, m)), ref.master)
    got = grads_of(lambda m: L.embed(torch.from_numpy(toks),
                                     STWeight(port.packed, m)), port.master)
    assert_close([got[0]] + got[1], [want[0]] + want[1])
    np.testing.assert_array_equal(
        got[0], L.embed(torch.from_numpy(toks), port.packed).numpy())
    touched = np.zeros(32, bool)
    touched[np.unique(toks)] = True
    norms = np.abs(got[1][0]).sum(-1)
    assert (norms[touched] > 0).all() and (norms[~touched] == 0).all()


def test_st_norm_scale_decodes_straight_through():
    """A stacked (L, d) norm scale sliced to one layer (``layer``):
    values from the codes, the gradient into that layer's row of the
    master only."""
    rng = np.random.default_rng(4)
    ref, port = pair(rng, (4, 64))
    xj, xt = x_of(rng, (2, 64))
    want = ref_grads_of(lambda x, m: RL.rms_norm(
        x, jax.tree_util.tree_map(lambda a: a[1], RefST(ref.packed, m))),
        xj, ref.master)
    got = grads_of(lambda x, m: L.rms_norm(
        x, STWeight(port.packed, m).layer(1)), xt, port.master)
    assert_close([got[0]] + got[1], [want[0]] + want[1])
    np.testing.assert_array_equal(
        got[0], L.rms_norm(xt, port.packed.layer(1)).numpy())
    rows = np.abs(got[1][1]).sum(-1)
    assert rows[1] > 0 and rows[[0, 2, 3]].sum() == 0


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("transpose", [False, True])
def test_packed_matmul_dw_matches_reference(transpose, batched):
    rng = np.random.default_rng(7)
    lead = (3, 5) if batched else (2, 5)
    x = rng.standard_normal(lead + (24,)).astype(np.float32)
    g = rng.standard_normal(lead + (40,)).astype(np.float32)
    want = RR.packed_matmul_dw_ref(jnp.asarray(x), jnp.asarray(g),
                                   transpose, batched)
    got = kref.packed_matmul_dw_ref(torch.from_numpy(x), torch.from_numpy(g),
                                    transpose, batched)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------------------------------
# the optimizer, the re-encode, the staleness probe, error feedback
# ---------------------------------------------------------------------------

def within_one_code(got_words, want_words, bits, n, outliers=0.0):
    """The words decode to values at most one code step apart (a sum in
    another order may round a value to a neighbouring code). With
    ``outliers``, up to that share of the values (at least one) may be
    further apart, each still within one code step at the leaf's
    largest magnitude: a one-code difference carried into a later step
    can leave a nearly cancelled value a few of its own codes apart."""
    fmt = FLOAT_FORMATS[bits]
    a = bitpack.unpack_floats(got_words, bits, n).numpy()
    b = bitpack.unpack_floats(torch.from_numpy(
        np.asarray(want_words).view(np.int32).copy()), bits, n).numpy()
    diff = np.abs(a - b)
    tiny = 2.0 ** (2 - 2 ** (fmt.exp_bits - 1) - fmt.mantissa_bits)
    step = np.maximum(np.abs(a), np.abs(b)) * 2.0 ** -fmt.mantissa_bits
    far = int((diff > step + tiny).sum())
    assert far <= (max(1, outliers * diff.size) if outliers else 0), (
        far, diff.max())
    assert diff.max() <= np.abs(b).max() * 2.0 ** -fmt.mantissa_bits + tiny


def opt_tree(rng):
    """A small parameter tree: two leaves of rank 2 (one ragged) and a
    vector."""
    return {"w": rng.standard_normal((8, 64)).astype(np.float32),
            "r": rng.standard_normal((3, 40)).astype(np.float32) * 0.1,
            "b": rng.standard_normal((64,)).astype(np.float32)}


def test_adamw_update_matches_reference():
    """Two updates (the second from non-zero packed moments) on the same
    grads: masters within 1e-6, the AF16 moments' words within one code
    step, the step count."""
    rng = np.random.default_rng(0)
    params = opt_tree(rng)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) * s
              for k, v in params.items()} for s in (1.0, 0.01)]
    rcfg = RefAdamWConfig(lr=1e-3, m_bits=16, v_bits=16)
    cfg = AdamWConfig(lr=1e-3, m_bits=16, v_bits=16)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    from repro.optim import adamw_init as ref_adamw_init
    rstate = jax.jit(lambda p: ref_adamw_init(p, rcfg))(rp)
    pstate = adamw_init(pp, cfg)
    upd = jax.jit(lambda g, s, p, lr: ref_adamw_update(g, s, p, rcfg, lr))
    for step, g in enumerate(grads):
        lr = cosine_schedule(step, 1e-3, 1, 10)
        rp, rstate = upd({k: jnp.asarray(v) for k, v in g.items()}, rstate,
                         rp, jnp.float32(lr))
        pp, pstate = adamw_update({k: torch.from_numpy(v) for k, v in
                                   g.items()}, pstate, pp, cfg, lr)
    for k in params:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]),
                                   rtol=0, atol=1e-6)
    for name in ("m", "v"):
        for k, v in params.items():
            if v.ndim >= 2:
                within_one_code(pstate[name][k], rstate[name][k], 16,
                                v.shape[-1])
            else:
                np.testing.assert_allclose(pstate[name][k].numpy(),
                                           np.asarray(rstate[name][k]),
                                           rtol=1e-5, atol=1e-12)
    assert int(pstate["count"]) == int(rstate["count"]) == 2


def test_adamw_update_in_row_chunks_is_the_same(monkeypatch):
    """A leaf taken in row chunks (``REPACK_CHUNK`` cut to 100 values)
    updates exactly as taken whole."""
    import repro_torch.optim.adamw as adamw_mod
    rng = np.random.default_rng(1)
    params = opt_tree(rng)
    g = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32)) for k, v in params.items()}
    cfg = AdamWConfig(lr=1e-3, m_bits=16, v_bits=12)
    outs = []
    for chunk in (None, 100):
        if chunk:
            monkeypatch.setattr(adamw_mod, "REPACK_CHUNK", chunk)
            assert len(row_chunks((8, 64))) == 8
        p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
        st = adamw_init(p, cfg)
        for _ in range(2):
            p, st = adamw_update(g, st, p, cfg, 1e-3)
        outs.append((p, st))
    for k in params:
        assert torch.equal(outs[0][0][k], outs[1][0][k])
        assert torch.equal(outs[0][1]["v"][k], outs[1][1]["v"][k])


def test_cosine_schedule_matches_reference():
    for step in range(14):
        want = float(ref_cosine(jnp.int32(step), 3e-4, 3, 10))
        assert math.isclose(cosine_schedule(step, 3e-4, 3, 10), want,
                            rel_tol=1e-6), step


@pytest.mark.parametrize("bits", [8, 12, 16])
def test_repack_and_staleness_match_reference(bits):
    """A repack from the masters gives the reference's words bit for bit
    and staleness exactly 0.0; stale codes and drifted masters give the
    reference's staleness exactly."""
    rng = np.random.default_rng(bits)
    masters = {"w": rng.standard_normal((8, 64)).astype(np.float32),
               "norm": rng.standard_normal((64,)).astype(np.float32)}
    rm = {k: jnp.asarray(v) for k, v in masters.items()}
    pm = {k: torch.from_numpy(v) for k, v in masters.items()}
    r_stale = {"w": ref_pack_tensor(jnp.zeros((8, 64)), bits),
               "norm": rm["norm"]}
    p_stale = {"w": pack_tensor(torch.zeros((8, 64)), bits),
               "norm": pm["norm"]}
    assert packed_staleness(p_stale, pm) == float(
        ref_staleness(r_stale, rm)) > 0
    r_new, p_new = ref_repack_params(r_stale, rm), repack_params(p_stale, pm)
    np.testing.assert_array_equal(p_new["w"].data.numpy(),
                                  np.asarray(r_new["w"].data).view(np.int32))
    assert is_packed(p_new["w"]) and p_new["norm"] is not pm["norm"]
    assert packed_staleness(p_new, pm) == 0.0
    drift = {"w": pm["w"] + 0.25, "norm": pm["norm"]}
    assert packed_staleness(p_new, drift) == float(ref_staleness(
        r_new, {"w": rm["w"] + 0.25, "norm": rm["norm"]})) > 0


def test_error_feedback_matches_reference():
    """g' = g + r quantized at AF8 and the new residual, bit for bit, on
    leaves of rank 2 and 1."""
    rng = np.random.default_rng(6)
    grads = {"w": rng.standard_normal((5, 40)).astype(np.float32),
             "b": rng.standard_normal((7,)).astype(np.float32)}
    res = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-3
           for k, v in grads.items()}
    want = jax.jit(lambda g, r: ref_apply_ef(g, r, 8))(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in res.items()})
    got = apply_error_feedback({k: torch.from_numpy(v) for k, v in
                                grads.items()},
                               {k: torch.from_numpy(v) for k, v in
                                res.items()}, 8)
    for g_tree, w_tree in zip(got, want):
        for k in grads:
            np.testing.assert_array_equal(g_tree[k].numpy(),
                                          np.asarray(w_tree[k]))
    zeros = init_error_feedback({k: torch.from_numpy(v)
                                 for k, v in grads.items()})
    assert all(z.dtype == torch.float32 and not z.any()
               for z in zeros.values())
    same = apply_error_feedback(got[0], got[1], None)
    assert same[0] is got[0] and same[1] is got[1]


def test_grad_loop_microbatches_average_to_the_whole_batch():
    """Two microbatches of one row each give the whole batch's loss and
    gradients, as the reference's scan does."""
    torch.manual_seed(0)
    w = {"w": torch.randn(6, 4)}
    batch = {"x": torch.randn(2, 3, 6), "y": torch.randn(2, 3, 4)}

    def loss_fn(p, b):
        return ((b["x"] @ p["w"] - b["y"]) ** 2).mean()

    w["w"].requires_grad_(True)
    whole = _grad_loop(loss_fn, w, batch, TrainConfig())
    micro = _grad_loop(loss_fn, w, batch, TrainConfig(microbatches=2))
    assert torch.allclose(whole[0], micro[0], atol=1e-6)
    assert torch.allclose(whole[1]["w"], micro[1]["w"], atol=1e-6)
    assert micro[1]["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the data stream and the watchdog
# ---------------------------------------------------------------------------

def test_synthetic_tokens_restart_exact_in_range_quarter_mean():
    data = SyntheticTokens(vocab_size=512, seq_len=64, global_batch=32,
                           seed=3)
    a, b = data.batch_at(5), SyntheticTokens(512, 64, 32, seed=3).batch_at(5)
    assert torch.equal(a.tokens, b.tokens) and torch.equal(a.labels,
                                                           b.labels)
    assert a.tokens.dtype == torch.int32 and a.tokens.shape == (32, 64)
    assert torch.equal(a.tokens[:, 1:], a.labels[:, :-1])
    assert not torch.equal(a.tokens, data.batch_at(6).tokens)
    ids = torch.cat([data.batch_at(s).tokens for s in range(8)]).float()
    assert ids.min() >= 0 and ids.max() < 512
    # floor(v u^3) / v has mean 1/4 - 1/(2v); the reference draws the
    # same marginal from JAX's PRNG
    ref = RefTokens(512, 64, 32, seed=3).batch_at(5).tokens
    for sample in (ids, torch.from_numpy(np.array(ref)).float()):
        assert abs(sample.mean().item() / 512 - 0.25) < 0.02
    shard = SyntheticTokens(512, 64, 32, seed=3, host_index=1,
                            host_count=2)
    assert shard.batch_at(5).tokens.shape == (16, 64)
    assert not torch.equal(shard.batch_at(5).tokens, a.tokens[:16])
    data.step = 7
    other = SyntheticTokens(512, 64, 32)
    other.load_state_dict(data.state_dict())
    assert (other.step, other.seed) == (7, 3)
    assert set(a.as_dict({"frames": 0})) == {"tokens", "labels", "frames"}
    it = iter(other)
    assert torch.equal(next(it).tokens, data.batch_at(7).tokens)
    assert other.step == 8


def test_straggler_watchdog_flags_slow_steps():
    seen = []
    wd = StragglerWatchdog(ratio=2.0, warmup_steps=3,
                           on_straggle=lambda s, t, b: seen.append(s))
    flags = [wd.observe(i, t) for i, t in
             enumerate([1.0, 1.0, 1.0, 1.1, 5.0, 1.0])]
    assert flags == [False, False, False, False, True, False]
    assert wd.events == 1 and seen == [4]
    assert 1.0 <= wd.baseline < 1.1 and len(wd.history) == 6


def test_preemption_guard_sets_and_restores():
    import signal
    prev = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard(install=True)
    assert not guard.requested
    signal.raise_signal(signal.SIGTERM)
    assert guard.requested
    guard.restore()
    assert signal.getsignal(signal.SIGTERM) == prev
    assert not PreemptionGuard(install=False).requested


def test_views_of_a_training_tree_are_not_kept():
    """``LM`` keeps the per-layer views of a serving tree, but builds those
    of a training tree (``STWeight``s, or tensors that require grad) anew
    on every call and keeps none: they would hold the last step's graph
    and a decode of masters updated in place since."""
    from repro_torch.configs import get_config
    from repro_torch.core.compress import repacked_copy, uniform_plan
    from repro_torch.core.tensor_store import st_tree, tree_leaves
    from repro_torch.models.lm import LM

    lm = LM(get_config("qwen3_8b").reduced(), device="cpu")
    params = lm.init()
    packed = repacked_copy(params, uniform_plan(params, 16))
    batch = {k: torch.randint(0, 512, (1, 8)) for k in ("tokens", "labels")}
    with torch.no_grad():
        lm.loss(packed, batch)
    assert lm._views[0] is packed
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    tree = st_tree(packed, params)
    losses = []
    for _ in range(2):
        loss = lm.loss(tree, batch)
        assert lm._views is None
        loss.backward()
        with torch.no_grad():            # an in-place update, as AdamW's
            params["blocks"]["attn"]["ln"].add_(1.0)
        losses.append(loss.item())
    # the forward reads the codes, which the update did not change
    assert losses[0] == losses[1]
    assert params["blocks"]["attn"]["ln"].grad.abs().sum() > 0
