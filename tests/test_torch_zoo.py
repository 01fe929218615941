"""The dense zoo configs the port had not served (phi3-medium-14b,
stablelm-12b, granite-34b, paper_native) against the JAX reference, on
the CPU, and the packing engine's own init for every family.

Each config is cut to a size that keeps what is new in it (``reduced()``
would erase it: head_dim 32, 4 heads):

  * phi3-medium-14b at ``reduced()``: GQA group 4, its AF12 draft;
  * stablelm-12b with head_dim 160 (5 groups of 32 codes a head, 80
    words at AF16), its AF8 draft;
  * granite-34b with 48 query heads on one KV head (MQA, group 48) and
    its non-gated GELU MLP, its AF12 draft;
  * paper_native as published (2 layers, d_model 256, head_dim 64,
    group 2; f32 as every reduced config), ``NO_COMPRESSION``: plain
    weights and a plain KV cache, and also with ``pack_weights=True``.

As ``tests/test_torch_families.py`` does: one reference ``ServeEngine``
per config, drained once per module; its parameters carried across with
``repro_torch.interop``; the port's engines on the CPU drain the same
requests, dense and paged, and the speculative engine (greedy) gives the
plain tokens; decode logits within 1e-4 a call from the reference's
state.
"""
from __future__ import annotations

import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.compress import repack, uniform_plan
from repro_torch.core.tensor_store import (is_draw, is_packed,
                                           tree_map_with_path)
from repro_torch.models.lm import LM
from repro_torch.serving import ServeEngine, SpeculativeEngine
from test_torch_families import (PAGE, check_counters,  # noqa: F401
                                 check_init_tree, decode_steps,
                                 one_torch_thread, port_run, reference_run)

# (arch, config overrides, engine overrides): the trait-keeping sizes
ZOO = {
    "phi3_medium_14b": ({}, ()),
    "stablelm_12b": ({"head_dim": 160}, ()),
    "granite_34b": ({"n_heads": 48, "n_kv_heads": 1}, ()),
    "paper_native": ({"dtype": "float32"}, (("pack_weights", False),)),
    "paper_native packed": ({"dtype": "float32"}, ()),
}
# the draft width each speculating config declares
DRAFTS = {"phi3_medium_14b": 12, "stablelm_12b": 8, "granite_34b": 12}
# the packed init's decoded statistics: within STAT_SE standard errors of
# the draw's (mean 0, std ``scale``), the std also within one AF16 code
# step (2^-10, relative) for the codes' rounding
STAT_SE, CODE_STEP = 5.0, 2.0 ** -10
ARCHS = ("qwen3_8b", "deepseek_moe_16b", "paligemma_3b", "whisper_small",
         "falcon_mamba_7b", "recurrentgemma_9b", "phi3_medium_14b",
         "stablelm_12b", "granite_34b", "arctic_480b", "paper_native")


def zoo_run(name):
    overrides, engine_kw = ZOO[name]
    return reference_run(name.split()[0], engine_kw=engine_kw, **overrides)


@pytest.fixture(scope="module", params=list(ZOO))
def zoo(request):
    return zoo_run(request.param)


@pytest.fixture(scope="module")
def dense(zoo):
    return port_run(zoo)


def test_traits_survive_the_cut(zoo):
    """The served config keeps what is new in it, on both sides."""
    eng = zoo["engine"]
    cfg = eng.cfg
    arch = zoo["arch"]
    if arch == "stablelm_12b":
        assert cfg.resolved_head_dim == 160
    elif arch == "granite_34b":
        assert cfg.n_heads // cfg.n_kv_heads == 48 and not cfg.gated_mlp
    elif arch == "phi3_medium_14b":
        assert cfg.n_heads // cfg.n_kv_heads == 4
    else:
        assert cfg.n_layers == 2 and cfg.d_model == 256
        assert cfg.compression.kv_bits is None
        packs = zoo["engine_kw"].get("pack_weights", True)
        assert (eng.weight_plan is not None) == packs


def test_greedy_tokens_identical(zoo, dense):
    assert dense["outs"] == zoo["outs"]
    check_counters(zoo, dense)


def test_paged_tokens_identical(zoo):
    paged = port_run(zoo, paged=True, kv_page_size=PAGE)
    assert paged["outs"] == zoo["outs"]
    assert paged["stats"]["prefill_calls"] == zoo["stats"]["prefill_calls"]
    assert not (paged["stats"]["pool_pages_used"]
                or paged["stats"]["pool_pages_reserved"])


@pytest.mark.parametrize("arch", sorted(DRAFTS))
def test_speculative_greedy_gives_plain_tokens(arch):
    run = zoo_run(arch)
    spec = port_run(run, SpeculativeEngine, k=2)
    assert spec["stats"]["draft_bits"] == DRAFTS[arch]
    assert spec["outs"] == run["outs"]
    assert spec["stats"]["spec_ticks"] > 0


def test_decode_step_logits_match(zoo):
    decode_steps(zoo, 3)


def test_init_tree_matches_reference(zoo):
    check_init_tree(zoo)


# ---------------------------------------------------------------------------
# the packing engine's own init: each leaf drawn slice by slice, packed
# ---------------------------------------------------------------------------

def _leaves(tree):
    out = {}
    tree_map_with_path(lambda p, leaf: out.setdefault(p, leaf), tree)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_init_is_init_then_repack_in_distribution(arch):
    """``ServeEngine(pack_weights=True)`` with no params draws its own
    packed tree: the keys, logical and word shapes, dtypes, kinds and
    widths of ``repack(LM.init(), uniform_plan(...))``; every leaf
    ``LM.init`` makes without the generator bit for bit that tree's; and
    each random leaf's decoded mean and std within STAT_SE standard
    errors of the draw's (its scale), which the two trees draw from the
    same distribution with other numbers."""
    cfg = get_config(arch).reduced()
    bits = cfg.resolved_weight_bits
    eng = ServeEngine(cfg, max_seq_len=8, max_slots=1, pack_weights=True,
                      device="cpu")
    lm = LM(cfg, device="cpu")
    dense = lm.init()
    want = _leaves(repack(dense, uniform_plan(dense, bits)))
    got = _leaves(eng.params)
    draws = _leaves(lm.init_lazy())
    assert got.keys() == want.keys() == draws.keys()
    n_draws = 0
    for path, leaf in got.items():
        ref = want[path]
        assert is_packed(leaf) == is_packed(ref), path
        if not is_packed(leaf):
            assert leaf.dtype == ref.dtype and torch.equal(leaf, ref), path
            continue
        for field in ("bits", "kind", "signed", "logical_shape",
                      "out_dtype"):
            assert getattr(leaf, field) == getattr(ref, field), (path, field)
        assert leaf.data.shape == ref.data.shape, path
        assert leaf.bits == bits
        values = leaf.unpack().double()
        if not is_draw(draws[path]):
            assert torch.equal(values, ref.unpack().double()), path
            continue
        n_draws += 1
        scale, n = draws[path].scale, values.numel()
        assert abs(values.mean().item()) <= STAT_SE * scale / math.sqrt(n), \
            path
        rel = values.std().item() / scale - 1.0
        assert abs(rel) <= STAT_SE / math.sqrt(2 * n) + CODE_STEP, path
    assert n_draws == sum(map(is_draw, draws.values()))


def test_packed_init_draws_one_slice_at_a_time(monkeypatch):
    """A stacked leaf is drawn a layer at a time, a bank an expert of a
    layer at a time: no draw the engine makes is larger than one
    (rows, cols) slice of a leaf."""
    cfg = get_config("arctic_480b").reduced()
    shapes = []
    randn = torch.randn

    def recording(*shape, **kw):
        shapes.append(tuple(shape[0]) if len(shape) == 1 else shape)
        return randn(*shape, **kw)

    monkeypatch.setattr(torch, "randn", recording)
    ServeEngine(cfg, max_seq_len=8, max_slots=1, pack_weights=True,
                device="cpu")
    assert shapes and all(len(s) == 2 for s in shapes)
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    per_layer_bank = sum(s in ((d, f), (f, d)) for s in shapes)
    assert per_layer_bank >= 3 * e * cfg.n_layers
