"""Packed-master and dense train steps of the port against the JAX
reference for the moe family (deepseek-moe-16b: the expert banks' dx
through the batched kernel's transposed orientation, dW per expert, the
router and the capacity drop), on the CPU: ``tests/test_torch_train.py``'s
comparison and tolerances.
"""
from __future__ import annotations

import pytest

from test_torch_serve import one_torch_thread  # noqa: F401
from test_torch_train import check_grads, check_losses, check_state

ARCH = "deepseek_moe_16b"


@pytest.mark.parametrize("mode", ["packed", "dense"])
def test_train_step_losses_match(mode):
    check_losses(ARCH, mode)


@pytest.mark.parametrize("mode", ["packed", "dense"])
def test_train_step_master_grads_match(mode):
    check_grads(ARCH, mode)


@pytest.mark.parametrize("mode", ["packed", "dense"])
def test_train_step_masters_moments_and_codes_match(mode):
    check_state(ARCH, mode)
