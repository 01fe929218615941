"""The ssm (falcon-mamba-7b) and hybrid (recurrentgemma-9b) serving paths
against the JAX reference, on the CPU.

One reference ``ServeEngine`` per family (reduced config, AF16 packed
weights and AF16 packed KV, 2 slots) is built and drained once per
module, and the port's engine drains the same requests on the same
packed words (``tests/test_torch_families.py``'s helpers). The
recurrent families feed their prompts one token a tick. ssm serves more
requests than slots, so requests start in recycled slots, whose
recurrent state neither package clears. hybrid runs with ``attn_window``
8 and sequences past it, so its attention ring wraps, and with 8 layers,
two groups of (2 RG-LRU, 1 attention) and a tail of 2 RG-LRU layers.
Decode logits are held within 1e-4 per call and the recurrent state
within 1e-5 (f32), the Mamba, RG-LRU and windowed attention blocks
within 1e-5, and what the reference refuses (paged KV, speculation,
rollback, per-layer KV widths) is refused with its error types.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import blocks as RB
from repro.models.lm import LM as RefLM
from repro.serving import ServeEngine as RefEngine
from repro.serving import SpeculativeEngine as RefSpeculative

from repro_torch.launch import serve
from repro_torch.models import blocks as B
from repro_torch.models.lm import LM, Refused
from repro_torch.serving import ServeEngine, SpeculativeEngine
from test_torch_families import (BLOCK_TOL, check_counters,  # noqa: F401
                                 check_init_tree, configs, decode_steps,
                                 jitted, one_torch_thread, packed_block,
                                 port_run, random_words, reference_run,
                                 to_jax)

# ssm: five requests on two slots (three start in recycled slots)
SSM_LENS = (5, 0, 9, 1, 3)
HYBRID = dict(attn_window=8, n_layers=8)
RUNS = {"falcon_mamba_7b": (SSM_LENS, {}),
        "recurrentgemma_9b": ((5, 0, 9, 1), HYBRID)}


def _run(arch):
    lens, overrides = RUNS[arch]
    return reference_run(arch, lens, **overrides)


@pytest.fixture(scope="module", params=list(RUNS))
def fam(request):
    return _run(request.param)


@pytest.fixture(scope="module")
def dense(fam):
    return port_run(fam)


def test_greedy_tokens_identical(fam, dense):
    assert dense["outs"] == fam["outs"]
    check_counters(fam, dense)
    # no chunked prefill: every prompt token went through a tick
    assert dense["stats"]["prefill_calls"] == 0
    assert dense["stats"]["decode_calls"] > max(fam["lens"])


def _recurrent_parts(state):
    """(name, port tensor, reference array) of a state's recurrent
    leaves."""
    if "ssm" in state:
        return [("conv", state["conv"]), ("ssm", state["ssm"])]
    parts = [(f"rec.{n}", state["rec"][n]) for n in ("conv", "h")]
    if "tail_rec" in state:
        parts += [(f"tail_rec.{n}", state["tail_rec"][n])
                  for n in ("conv", "h")]
    return parts


def _ref_part(ref_state, name):
    node = ref_state
    for key in name.split("."):
        node = node[key]
    return np.asarray(node)


def test_decode_step_logits_match(fam):
    """From recurrent state of random values (numpy seed) and, for the
    hybrid, lengths 5 and 7, so four calls wrap the 8-row ring: logits
    within 1e-4 per call, recurrent state within 1e-5."""
    rng = np.random.default_rng(12)

    def setup(ref_state, state):
        out = dict(ref_state)
        for name, t in _recurrent_parts(state):
            t.copy_(torch.from_numpy(
                rng.standard_normal(tuple(t.shape)).astype(np.float32)))
            keys = name.split(".")
            if len(keys) == 1:
                out[keys[0]] = to_jax(t)
            else:
                out[keys[0]] = dict(out[keys[0]], **{keys[1]: to_jax(t)})
        if "kv" in state:
            lens = torch.tensor([5, 7], dtype=torch.int32)
            state["len"] = lens
            out["len"] = jnp.asarray(lens.numpy())
        return out

    ref_state, state = decode_steps(fam, 4, setup, seed=7)
    for name, t in _recurrent_parts(state):
        np.testing.assert_allclose(t.numpy(), _ref_part(ref_state, name),
                                   rtol=0, atol=BLOCK_TOL, err_msg=name)


def test_recycled_slots_carry_state_in_both(fam, dense):
    """A recycled slot's recurrent state is not cleared, by either
    package (the reference's ``_reset_slot`` zeroes only the length),
    and after the drain both engines hold the same state, within 1e-3:
    along a drain the appended AF16 KV rows may round a code apart
    (ROADMAP Queue C: logits drift up to 4e-4 with identical tokens)."""
    for eng in (fam["engine"], dense["engine"]):
        before = {n: np.array(_ref_part(eng.state, n))
                  for n, _ in _recurrent_parts(dense["engine"].state)}
        assert any(np.abs(v).max() > 0 for v in before.values())
        eng._reset_slot(0)
        for n, v in before.items():
            np.testing.assert_array_equal(np.array(_ref_part(eng.state, n)),
                                          v)
        assert int(np.asarray(eng.state["len"])[0]) == 0
    for name, t in _recurrent_parts(dense["engine"].state):
        np.testing.assert_allclose(t.numpy(),
                                   _ref_part(fam["engine"].state, name),
                                   rtol=0, atol=1e-3, err_msg=name)


def test_hybrid_ring_wraps_and_tail_runs(fam, dense):
    eng = dense["engine"]
    if eng.cfg.family != "hybrid":
        assert set(eng.state) == {"len", "conv", "ssm"}
        return
    lm = eng.lm
    assert len(lm.layer_params(eng.params)) == eng.cfg.n_layers == 8
    assert "tail" in eng.params and eng.state["tail_rec"]["h"].shape[0] == 2
    assert eng.state["kv"]["k"].shape[2] == eng.cfg.attn_window == 8
    assert max(fam["lens"]) + 3 - 1 > eng.cfg.attn_window
    assert eng.state["tail_rec"]["h"].abs().max() > 0


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _state_pair(shapes, seed):
    rng = np.random.default_rng(seed)
    port = {n: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for n, s in shapes.items()}
    return {n: jnp.asarray(t.numpy()) for n, t in port.items()}, port


def _check_block(want, ref_st, got, st, names):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BLOCK_TOL)
    for n in names:
        np.testing.assert_allclose(st[n].numpy(), np.asarray(ref_st[n]),
                                   rtol=0, atol=BLOCK_TOL, err_msg=n)


def test_mamba_block_matches_reference():
    pc, cfg = configs("falcon_mamba_7b")
    p, pp = packed_block(RB.init_mamba, cfg)
    b, di = 3, cfg.d_inner
    ref_st, st = _state_pair({"conv": (b, cfg.d_conv - 1, di),
                              "ssm": (b, di, cfg.ssm_state)}, 13)
    x = np.random.default_rng(14).standard_normal(
        (b, 1, cfg.d_model)).astype(np.float32)
    want, ref_new = jitted(RB.mamba_decode, cfg=cfg)(p, jnp.asarray(x),
                                                     state=ref_st)
    got, new = B.mamba_decode(pp, torch.from_numpy(x), pc, st)
    _check_block(want, ref_new, got, new, ("conv", "ssm"))


def test_rglru_block_matches_reference():
    pc, cfg = configs("recurrentgemma_9b")
    p, pp = packed_block(RB.init_rglru, cfg)
    b, lw = 3, cfg.lru_width
    ref_st, st = _state_pair({"conv": (b, cfg.d_conv - 1, lw),
                              "h": (b, lw)}, 15)
    x = np.random.default_rng(16).standard_normal(
        (b, 1, cfg.d_model)).astype(np.float32)
    want, ref_new = jitted(RB.rglru_decode, cfg=cfg)(p, jnp.asarray(x),
                                                     state=ref_st)
    got, new = B.rglru_decode(pp, torch.from_numpy(x), pc, st)
    _check_block(want, ref_new, got, new, ("conv", "h"))


def test_windowed_attention_block_matches_reference():
    """The row lands at ``len % window`` (a ring of 8 rows; lengths 3, 8,
    13 and 21 wrap), attention reads min(len + 1, window) rows; no other
    row changes."""
    pc, cfg = configs("recurrentgemma_9b")
    p, pp = packed_block(RB.init_attention, cfg)
    win, d, hkv = 8, cfg.resolved_head_dim, cfg.n_kv_heads
    lens = np.array([3, 8, 13, 21], np.int32)
    b = len(lens)
    k0 = random_words((b, win, hkv), d, seed=40)
    v0 = random_words((b, win, hkv), d, seed=41)
    x = np.random.default_rng(17).standard_normal(
        (b, 1, cfg.d_model)).astype(np.float32)
    want, ref_st = jitted(RB.attention_decode, cfg=cfg, window=win)(
        p, jnp.asarray(x), state={"k": to_jax(k0), "v": to_jax(v0),
                                  "len": jnp.asarray(lens)},
        positions=jnp.asarray(lens[:, None]))
    st = {"k": k0.clone(), "v": v0.clone(), "len": torch.from_numpy(lens)}
    got, st = B.attention_decode(pp, torch.from_numpy(x), pc, st,
                                 torch.from_numpy(lens[:, None]),
                                 kv_bits=16, window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=BLOCK_TOL)
    slot = lens % win
    for name, old in (("k", k0), ("v", v0)):
        ours = st[name].numpy()
        theirs = np.asarray(ref_st[name]).view(np.int32)
        for bi in range(b):
            changed = np.nonzero((ours[bi] != old[bi].numpy()).any(
                axis=(1, 2)))[0].tolist()
            assert changed == [slot[bi]], (name, bi, changed)
            keep = np.arange(win) != slot[bi]
            np.testing.assert_array_equal(ours[bi][keep], theirs[bi][keep])


# ---------------------------------------------------------------------------
# refusals, with the reference's error types
# ---------------------------------------------------------------------------

def _refusal(port_side, ref_side):
    """The reference raises ValueError; the port its subclass ``Refused``
    (caught as the reference's is, and told apart from a fault)."""
    errors = []
    for side in (port_side, ref_side):
        with pytest.raises(Exception) as e:
            side()
        errors.append(e.type)
    assert errors == [Refused, ValueError] and issubclass(Refused, ValueError)


@pytest.mark.parametrize("arch", list(RUNS))
def test_paged_mode_refused(arch):
    pc, rc = configs(arch)
    kw = dict(max_seq_len=16, max_slots=1, paged=True, kv_page_size=8)
    _refusal(lambda: ServeEngine(pc, device="cpu", **kw),
             lambda: RefEngine(rc, **kw))
    _refusal(lambda: LM(pc, device="cpu").init_paged_decode_state(1, 16, 8,
                                                                  2),
             lambda: RefLM(rc).init_paged_decode_state(1, 16, 8, 2))


@pytest.mark.parametrize("arch", list(RUNS))
def test_speculation_refused(arch):
    pc, rc = configs(arch)
    kw = dict(max_seq_len=16, max_slots=1, k=2)
    _refusal(lambda: SpeculativeEngine(pc, device="cpu", **kw),
             lambda: RefSpeculative(rc, **kw))


@pytest.mark.parametrize("arch", list(RUNS))
def test_rollback_refused(arch):
    pc, rc = configs(arch)
    assert not LM(pc, device="cpu").supports_rollback
    assert not RefLM(rc).supports_rollback
    _refusal(lambda: LM(pc, device="cpu").rollback_decode_state({}, [0]),
             lambda: RefLM(rc).rollback_decode_state({}, jnp.zeros(1)))


@pytest.mark.parametrize("arch", list(RUNS) + ["whisper_small"])
def test_kv_layer_bits_refused(arch):
    pc, rc = configs(arch)
    widths = (16,) * pc.n_kv_layers

    def with_widths(cfg):
        return dataclasses.replace(cfg, compression=dataclasses.replace(
            cfg.compression, kv_bits=16, kv_layer_bits=widths))

    _refusal(lambda: LM(with_widths(pc), device="cpu").init_decode_state(
        1, 16), lambda: RefLM(with_widths(rc)).init_decode_state(1, 16))


def test_launcher_serves_and_refuses():
    """The launcher drains both families on the CPU, and exits with the
    engine's reason for paged or speculative serving."""
    for arch in RUNS:
        serve.main(["--arch", arch, "--reduced", "--pack-weights",
                    "--device", "cpu", "--requests", "3",
                    "--max-new-tokens", "2", "--slots", "2"])
        for mode in (["--paged"], ["--speculative", "2"]):
            with pytest.raises(SystemExit) as e:
                serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--slots", "1", *mode])
            assert e.value.code == 2


def test_launcher_lets_faults_through(monkeypatch):
    """Only the engine's refusals become a usage error: any other
    ValueError raised while the engine is built propagates."""
    def broken(*args, **kwargs):
        raise ValueError("a fault inside the engine")

    monkeypatch.setattr("repro_torch.serving.ServeEngine", broken)
    with pytest.raises(ValueError, match="a fault inside"):
        serve.main(["--arch", "falcon_mamba_7b", "--reduced", "--device",
                    "cpu"])


def test_init_tree_matches_reference(fam):
    check_init_tree(fam)
