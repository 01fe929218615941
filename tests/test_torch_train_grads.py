"""The gradient of ``LM.loss`` in packed-master mode against the JAX
reference for the vlm (paligemma-3b: its tied head's dx through the kernel's normal
orientation, the image prefix), ssm (falcon-mamba-7b: through the
Mamba-1 scan, the conv and the SSM diagonals decoded straight through)
and hybrid (recurrentgemma-9b: through the RG-LRU loop and the local
attention) families, on the CPU.

Each family's reduced config (f32), packed
at AF16 by the reference and carried across; one jit of the
reference's ``_grad_loop`` over ``LM.loss(st_tree(codes, masters))``
per family; the loss within 1e-5 relative and every master's gradient
within 1e-4 relative L2.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.compat import prng_key
from repro.core.compress import uniform_plan as ref_uniform_plan
from repro.core.tensor_store import st_tree as ref_st_tree
from repro.models.lm import LM as RefLM
from repro.train import loop as ref_loop

from repro_torch.core.tensor_store import st_tree, tree_leaves
from repro_torch.interop import params_from_numpy
from repro_torch.models.lm import LM
from repro_torch.train import loop
from test_torch_families import configs
from test_torch_prefill import make_batch, port_batch
from test_torch_serve import _jitted_repack, _numpy_tree
from test_torch_serve import one_torch_thread  # noqa: F401
from test_torch_train import GRAD_RTOL, LOSS_RTOL, T, _at, _leaves


@functools.lru_cache(maxsize=None)
def loss_grads(arch):
    """(reference, port) of (loss, master gradients) at the reference's
    AF16 codes and masters, on one numpy batch."""
    cfg, ref_cfg = configs(arch)
    lm = RefLM(ref_cfg)
    params = jax.jit(lm.init)(prng_key(0))
    packed = _jitted_repack(params, ref_uniform_plan(params, 16))
    batch = make_batch(cfg, seed=2, t=T)
    tc = ref_loop.TrainConfig()
    loss, grads = jax.jit(lambda pk, ms, b: ref_loop._grad_loop(
        lambda m, mb: lm.loss(ref_st_tree(pk, m), mb), ms, b, tc))(
            packed, params, {k: jnp.asarray(v) for k, v in batch.items()})
    port_lm = LM(cfg, device="cpu")
    pk = params_from_numpy(_numpy_tree(packed), device="cpu")
    ms = params_from_numpy(_numpy_tree(params), device="cpu")
    for leaf in tree_leaves(ms):
        leaf.requires_grad_(True)
    got = loop._grad_loop(lambda m, b: port_lm.loss(st_tree(pk, m), b), ms,
                          port_batch(batch), loop.TrainConfig())
    return (float(loss), _numpy_tree(grads)), (float(got[0]), got[1])


@pytest.mark.parametrize("arch", ["paligemma_3b", "falcon_mamba_7b",
                                  "recurrentgemma_9b"])
def test_loss_gradient_matches(arch):
    (want_loss, want), (got_loss, got) = loss_grads(arch)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_RTOL)
    n = 0
    for path, w in _leaves(want):
        g = _at(got, path).numpy()
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= GRAD_RTOL, (path, rel)
        n += bool(np.abs(w).max() > 0)
    assert n >= len(_leaves(want)) - 1      # (a zero-init gate may be 0)
