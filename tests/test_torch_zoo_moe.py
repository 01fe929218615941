"""arctic-480b, the MoE zoo config the port had not served, against the
JAX reference on the CPU.

``reduced()`` keeps 8 of its 128 experts, top-2, and the dense residual
MLP that runs beside them, but cuts its 56 query heads on 8 KV heads to
4 on 1; the served config keeps the group of 7 (``n_heads=7,
n_kv_heads=1``). As ``tests/test_torch_families.py`` does: one
reference ``ServeEngine``, drained once per module, its packed
parameters carried across; the port's engines on the CPU drain the same
requests, dense and paged; decode logits within 1e-4 a call from the
reference's state; and the serve launcher drains the reduced config end
to end.
"""
from __future__ import annotations

import pytest

from repro_torch.launch import serve
from test_torch_families import (PAGE, check_counters,  # noqa: F401
                                 check_init_tree, decode_steps,
                                 one_torch_thread, port_run, reference_run)

ARCH = "arctic_480b"
OVERRIDES = {"n_heads": 7, "n_kv_heads": 1}


@pytest.fixture(scope="module")
def arctic():
    return reference_run(ARCH, **OVERRIDES)


def test_traits_survive_the_cut(arctic):
    cfg = arctic["engine"].cfg
    assert cfg.n_heads // cfg.n_kv_heads == 7
    assert cfg.dense_residual and cfg.experts_per_token == 2
    assert cfg.n_experts == 8 and not cfg.n_shared_experts


def test_greedy_tokens_identical(arctic):
    dense = port_run(arctic)
    assert dense["outs"] == arctic["outs"]
    check_counters(arctic, dense)


def test_paged_tokens_identical(arctic):
    paged = port_run(arctic, paged=True, kv_page_size=PAGE)
    assert paged["outs"] == arctic["outs"]
    assert paged["stats"]["prefill_calls"] == arctic["stats"]["prefill_calls"]
    assert not (paged["stats"]["pool_pages_used"]
                or paged["stats"]["pool_pages_reserved"])


def test_decode_step_logits_match(arctic):
    decode_steps(arctic, 3)


def test_init_tree_matches_reference(arctic):
    check_init_tree(arctic)


@pytest.mark.parametrize("argv", [
    ["--arch", "arctic_480b", "--reduced", "--pack-weights"],
    ["--arch", "arctic_480b", "--reduced", "--pack-weights", "--paged"],
    ["--arch", "paper_native"],
    ["--arch", "paper_native", "--paged"],
], ids=["arctic", "arctic-paged", "paper_native", "paper_native-paged"])
def test_launcher_serves_the_zoo_configs(argv, capsys):
    """The launcher drains reduced arctic (packed) and paper_native as
    published (plain weights and KV) on the CPU."""
    serve.main(argv + ["--device", "cpu", "--requests", "3",
                       "--max-new-tokens", "2", "--slots", "2"])
    assert "completed 3/3" in capsys.readouterr().out
