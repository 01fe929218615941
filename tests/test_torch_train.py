"""Packed-master and dense train steps of the port against the JAX
reference, on the CPU: the dense family (qwen3-8b) here, moe
(deepseek-moe-16b) in ``tests/test_torch_train_moe.py`` and encdec
(whisper-small) in ``tests/test_torch_train_encdec.py``, one family a
file so that test workers spread the reference's compiles.

Each family's reduced config (f32) is initialised by the reference,
packed at AF16 by its own ``repack`` and carried across with
``repro_torch.interop``; both sides take the same batch (a numpy seed)
and the same AdamW settings (AF16 moments). The port runs
``make_train_step`` twice in each mode (the second step starts from
non-zero packed moments and, packed-master, from repacked codes). The
reference runs its ``make_train_step``'s body (``_grad_loop``,
``cosine_schedule``, ``adamw_update``, ``repack_params``; no error
feedback) with one jit of each part, shared by both steps. Held:

  * the loss of each step within 1e-5 relative (f32; the sides differ
    in summation order only);
  * every master's gradient at the first step within 1e-4 relative L2;
  * the updated masters within 2e-5, all but at most 1 in 10,000 values
    of a leaf (or one value), and every value within 2 lr a step: an Adam step moves a
    master by about lr = 1e-3 whatever the gradient's size, so where a
    gradient is near AdamW's eps (1e-8) m / sqrt(v) turns on the last
    bits of its sums;
  * the moments' words and the repacked codes within one code step, all
    but 1 in 1,000 values of a leaf (or one value), which come within
    one code step at the leaf's largest magnitude: a value one code
    apart after the first step, carried into the second, can leave a
    nearly cancelled moment (or a code of an outlying master) a few of
    its own codes apart.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.compat import prng_key
from repro.core.compress import uniform_plan as ref_uniform_plan
from repro.core.tensor_store import st_tree as ref_st_tree
from repro.models.lm import LM as RefLM
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import cosine_schedule as ref_cosine
from repro.optim import repack_params as ref_repack_params
from repro.train import loop as ref_loop

from repro_torch.core.tensor_store import is_packed, st_tree, tree_leaves
from repro_torch.interop import params_from_numpy
from repro_torch.models.lm import LM
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import loop
from test_torch_families import configs
from test_torch_prefill import make_batch, port_batch
from test_torch_serve import _jitted_repack, _numpy_tree
from test_torch_st_layers import within_one_code
from test_torch_serve import one_torch_thread  # noqa: F401

LR, T, STEPS = 1e-3, 32, 2
LOSS_RTOL, GRAD_RTOL, MASTER_ATOL, MASTER_OUTLIERS = 1e-5, 1e-4, 2e-5, 1e-4
CODE_OUTLIERS = 1e-3


def _leaves(tree):
    """(path, leaf) of a reference tree in interop's numpy form."""
    if isinstance(tree, dict) and "logical_shape" not in tree:
        return [(k + "/" + p if p else k, leaf) for k, v in tree.items()
                for p, leaf in _leaves(v)]
    return [("", tree)]


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The reference's params, packed codes, batch, and per mode the
    losses, first-step gradients and final (codes,) masters and
    moments of STEPS steps, all in interop's numpy form."""
    cfg, ref_cfg = configs(arch)
    lm = RefLM(ref_cfg)
    params = jax.jit(lm.init)(prng_key(0))
    packed = _jitted_repack(params, ref_uniform_plan(params, 16))
    batch = make_batch(cfg, seed=1, t=T)
    feed = {k: jnp.asarray(v) for k, v in batch.items()}
    ocfg = RefAdamWConfig(lr=LR, m_bits=16, v_bits=16)
    tc = ref_loop.TrainConfig(steps=10, seq_len=T, global_batch=2, lr=LR)
    grads = {
        "packed": jax.jit(lambda pk, ms, b: ref_loop._grad_loop(
            lambda m, mb: lm.loss(ref_st_tree(pk, m), mb), ms, b, tc)),
        "dense": jax.jit(lambda pk, ms, b: ref_loop._grad_loop(
            lm.loss, ms, b, tc))}
    update = jax.jit(lambda g, s, p, lr: ref_adamw_update(g, s, p, ocfg,
                                                          lr))
    repack = jax.jit(ref_repack_params)
    state0 = jax.jit(lambda p: ref_adamw_init(p, ocfg))(params)
    out = {"params": _numpy_tree(params), "codes": _numpy_tree(packed),
           "batch": batch}
    for mode in ("packed", "dense"):
        pk, ms, st, losses = packed, params, state0, []
        for step in range(STEPS):
            loss, g = grads[mode](pk, ms, feed)
            if step == 0:
                out[mode + "_grads"] = _numpy_tree(g)
            losses.append(float(loss))
            ms, st = update(g, st, ms, ref_cosine(jnp.int32(step), LR,
                                                  tc.warmup, tc.steps))
            if mode == "packed":
                pk = repack(pk, ms)
        out[mode] = {"losses": losses, "masters": _numpy_tree(ms),
                     "m": _numpy_tree(st["m"]), "v": _numpy_tree(st["v"]),
                     "codes": _numpy_tree(pk)}
    return out


@functools.lru_cache(maxsize=None)
def port(arch):
    """The port's losses, first-step gradients and final state of STEPS
    ``make_train_step`` steps in each mode, from the reference's
    params, codes and batch."""
    cfg, _ = configs(arch)
    ref = reference(arch)
    lm = LM(cfg, device="cpu")
    ocfg = AdamWConfig(lr=LR, m_bits=16, v_bits=16)
    tc = loop.TrainConfig(steps=10, seq_len=T, global_batch=2, lr=LR)
    batch = port_batch(ref["batch"])
    out = {}
    for mode in ("packed", "dense"):
        ms = params_from_numpy(ref["params"], device="cpu")
        for leaf in tree_leaves(ms):
            leaf.requires_grad_(True)
        pk = params_from_numpy(ref["codes"], device="cpu")
        loss_fn = ((lambda m, b: lm.loss(st_tree(pk, m), b))
                   if mode == "packed" else lm.loss)
        out[mode + "_grads"] = loop._grad_loop(loss_fn, ms, batch, tc)[1]
        step_fn = loop.make_train_step(
            lm, ocfg, dataclasses.replace(tc, pack_params=mode == "packed"))
        st, losses = adamw_init(ms, ocfg), []
        for step in range(STEPS):
            if mode == "packed":
                pk, ms, st, _, loss = step_fn(pk, ms, st, 0, batch, step)
            else:
                ms, st, _, loss = step_fn(ms, st, 0, batch, step)
            losses.append(float(loss))
        out[mode] = {"losses": losses, "masters": ms, "m": st["m"],
                     "v": st["v"], "codes": pk}
    return out


def _at(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def check_losses(arch, mode):
    want = reference(arch)[mode]["losses"]
    got = port(arch)[mode]["losses"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def check_grads(arch, mode):
    want = reference(arch)[mode + "_grads"]
    got = port(arch)[mode + "_grads"]
    for path, w in _leaves(want):
        g = _at(got, path).numpy()
        w = np.asarray(w)
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= GRAD_RTOL, (path, rel)


def check_state(arch, mode):
    """Masters within MASTER_ATOL; moments (packed leaves of rank >= 2,
    f32 vectors) and, packed-master, the repacked codes within one code
    step."""
    want, got = reference(arch)[mode], port(arch)[mode]
    for path, w in _leaves(want["masters"]):
        diff = np.abs(_at(got["masters"], path).detach().numpy() - w)
        outliers = int((diff > MASTER_ATOL).sum())
        assert outliers <= max(1, MASTER_OUTLIERS * diff.size), (path, diff)
        assert diff.max() <= 2 * LR * STEPS, (path, diff.max())
        n = w.shape[-1]
        for name in ("m", "v"):
            g, r = _at(got[name], path), _at(want[name], path)
            if w.ndim >= 2:
                within_one_code(g, r, 16, n, CODE_OUTLIERS)
            else:
                np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                           atol=1e-9, err_msg=path)
    if mode != "packed":
        return
    n_codes = 0
    for path, w in _leaves(want["codes"]):
        g = _at(got["codes"], path)
        if isinstance(w, dict):               # a packed leaf
            assert is_packed(g) and g.bits == w["bits"] == 16
            within_one_code(g.data, w["data"], 16, w["logical_shape"][-1],
                            CODE_OUTLIERS)
            n_codes += 1
        else:
            assert not is_packed(g)
    assert n_codes > 0


@pytest.mark.parametrize("mode", ["packed", "dense"])
def test_train_step_losses_match(mode):
    check_losses("qwen3_8b", mode)


@pytest.mark.parametrize("mode", ["packed", "dense"])
def test_train_step_master_grads_match(mode):
    check_grads("qwen3_8b", mode)


@pytest.mark.parametrize("mode", ["packed", "dense"])
def test_train_step_masters_moments_and_codes_match(mode):
    check_state("qwen3_8b", mode)
