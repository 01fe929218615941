"""The port's ``Trainer``, its checkpoints and the train launcher, on the
CPU: the reference's packed-master contracts (``tests/
test_packed_training.py``) carried over, ``Trainer.run`` against the
reference ``Trainer`` on the same params and batches, a checkpoint the
reference wrote read by the port's ``CheckpointManager``, and the
launcher.

The reference ``Trainer`` runs once per module (reduced qwen3-8b,
packed-master, 3 steps, a checkpoint a step); the port's, with
``LM.init`` and ``SyntheticTokens.batch_at`` patched to the reference's
parameters and batches, gives the same losses within 1e-4 relative
(repacked codes may round a value to a neighbouring code: see
``tests/test_torch_train.py``) and the same weight-stream figures.
"""
from __future__ import annotations

import json
import os
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.compat import prng_key
from repro.configs import get_config as ref_get_config
from repro.core.tensor_store import PackedTensor as RefPacked
from repro.data import SyntheticTokens as RefTokens
from repro.models.lm import LM as RefLM
from repro.optim import adamw_init as ref_adamw_init
from repro.train import Trainer as RefTrainer
from repro.train import loop as ref_loop
from repro.train import TrainConfig as RefTrainConfig

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.compress import repack, uniform_plan
from repro_torch.core.tensor_store import (PackedTensor, is_packed,
                                           pack_tensor, tree_bytes,
                                           tree_leaves)
from repro_torch.data import SyntheticTokens, TokenBatch
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as launcher
from repro_torch.models.lm import LM
from repro_torch.optim import AdamWConfig
from repro_torch.train import Trainer, TrainConfig
from repro_torch.train.loop import make_train_step
from test_torch_serve import (_jitted_repack, _numpy_tree,  # noqa: F401
                              one_torch_thread)

RUN_RTOL = 1e-4
BASE = dict(seq_len=32, global_batch=2, lr=1e-3)


def cfg_of(arch="qwen3_8b"):
    return get_config(arch).reduced()


def run(arch="qwen3_8b", **kw):
    return Trainer(cfg_of(arch), TrainConfig(**dict(BASE, **kw)),
                   device="cpu").run()


# ---------------------------------------------------------------------------
# the reference's packed-master contracts
# ---------------------------------------------------------------------------

def test_repack_every_zero_rejected():
    tc = TrainConfig(pack_params=True, repack_every=0)
    with pytest.raises(ValueError, match="repack_every"):
        make_train_step(LM(cfg_of(), device="cpu"), AdamWConfig(), tc)


def test_trainer_repack_every_staleness_contract():
    m = run(steps=4, lr=1e-2, log_every=1, pack_params=True,
            repack_every=2)
    stale = dict(m["staleness"])
    assert stale[1] == 0.0 and stale[3] == 0.0     # just repacked
    assert stale[0] > 0 or stale[2] > 0            # stale in between
    assert m["repacks"] == 2


@pytest.mark.parametrize("arch", ["qwen3_8b", "deepseek_moe_16b",
                                  "whisper_small"])
def test_packed_master_loss_tracks_dense(arch):
    """Packed-master losses within 1e-2 of dense at every step (the
    ``BENCH_train_packed.json`` contract), the MoE's batched ST kernels
    and encdec's cross paths included."""
    dense = run(arch, steps=3)
    packed = run(arch, steps=3, pack_params=True)
    for d, p in zip(dense["losses"], packed["losses"]):
        assert abs(d - p) / abs(d) < 0.01, (dense["losses"],
                                            packed["losses"])
    assert len(packed["losses"]) == 3 and np.isfinite(packed["losses"]).all()


def test_packed_master_weight_stream_is_bits_over_32():
    params = LM(cfg_of(), device="cpu").init()
    packed = repack(params, uniform_plan(params, 16))
    pb, fb = tree_bytes(packed)
    # the forward and the fused dx backward each stream the words once
    assert 2 * pb <= 2 * (16 / 32) * fb * 1.02


@pytest.mark.parametrize("pack_params", [True, False])
def test_resume_after_save_is_bitwise(tmp_path, pack_params):
    """6 steps cut at 3 (repack_every 2): the resumed run's losses equal
    the uninterrupted run's bit for bit, and so do its final masters."""
    kw = dict(steps=6, checkpoint_every=3, pack_params=pack_params,
              repack_every=2)
    whole = run(checkpoint_dir=str(tmp_path / "a"), **kw)
    run(checkpoint_dir=str(tmp_path / "b"), **dict(kw, steps=3))
    resumed = run(checkpoint_dir=str(tmp_path / "b"), **kw)
    assert resumed["losses"] == whole["losses"][3:]
    assert resumed["last_step"] == 5
    name = "masters" if pack_params else "params"
    a = CheckpointManager(str(tmp_path / "a")).restore(5)[1][name]
    b = CheckpointManager(str(tmp_path / "b")).restore(5)[1][name]
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_checkpoint_carries_plan_and_dense_masters(tmp_path):
    tr = Trainer(cfg_of(), TrainConfig(steps=2, checkpoint_every=1,
                                       checkpoint_dir=str(tmp_path),
                                       pack_params=True, **BASE),
                 device="cpu")
    tr.run()
    step, tree, plan = tr.ckpt.restore(with_plan=True)
    assert step == 1 and plan is not None
    assert plan.float_bits == tr.plan.float_bits
    assert plan.int_bits == tr.plan.int_bits
    assert any(is_packed(l) for l in tree_leaves(tree["packed"]))
    assert not any(is_packed(l) for l in tree_leaves(tree["masters"]))
    assert set(tree) == {"packed", "masters", "opt", "data"}
    assert int(tree["data"]["step"]) == 2


# ---------------------------------------------------------------------------
# against the reference Trainer, and the reference's checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference Trainer: reduced qwen3-8b, packed-master, 3 steps,
    a checkpoint every step; its metrics, events, initial params and
    checkpoint directory."""
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    cfg = ref_get_config("qwen3_8b").reduced()
    tc = RefTrainConfig(steps=3, checkpoint_every=1, checkpoint_dir=d,
                        pack_params=True, log_every=1, **BASE)
    from repro import obs as ref_obs
    tracer = ref_obs.Tracer()
    # the reference's own initial encodes, jitted (eager they take ~20 s
    # of op-by-op compiles)
    with mock.patch.object(ref_loop, "repack", _jitted_repack), \
            mock.patch.object(ref_loop, "adamw_init",
                              jax.jit(ref_adamw_init, static_argnums=1)):
        metrics = RefTrainer(cfg, tc, tracer=tracer).run()
    params = jax.jit(RefLM(cfg).init)(prng_key(tc.seed))
    return {"metrics": metrics, "dir": d, "params": _numpy_tree(params),
            "final": tracer.events("train.metrics")[-1]["attrs"], "tc": tc}


def test_trainer_run_matches_reference(ref_run):
    """The port's Trainer on the reference's params and batches: losses
    within RUN_RTOL, staleness 0.0 after every repack, and the final
    ``train.metrics`` event with exactly ``TRAIN_FINAL_KEYS`` and the
    reference's step, repack and weight-stream figures."""
    ref_data = RefTokens(512, BASE["seq_len"], BASE["global_batch"])

    def init(self, gen=None):
        return params_from_numpy(ref_run["params"], device="cpu")

    def batch_at(self, step):
        b = ref_data.batch_at(step)
        return TokenBatch(torch.from_numpy(np.array(b.tokens)),
                          torch.from_numpy(np.array(b.labels)), step)

    tracer = obs.Tracer()
    tc = TrainConfig(steps=3, pack_params=True, log_every=1, **BASE)
    with mock.patch.object(LM, "init", init), \
            mock.patch.object(SyntheticTokens, "batch_at", batch_at):
        m = Trainer(cfg_of(), tc, tracer=tracer, device="cpu").run()
    np.testing.assert_allclose(m["losses"], ref_run["metrics"]["losses"],
                               rtol=RUN_RTOL)
    assert [s for _, s in m["staleness"]] == [0.0, 0.0, 0.0]
    final = tracer.events("train.metrics")[-1]["attrs"]
    assert set(final) == obs.TRAIN_FINAL_KEYS == set(ref_run["final"])
    for key in ("steps_completed", "last_step", "repacks", "weight_passes",
                "weight_read_bytes_fused", "weight_read_bytes_dense",
                "fused_analytic_bytes_per_pass", "straggler_events"):
        assert final[key] == ref_run["final"][key], key
    for ev in tracer.events("train.step"):
        assert obs.TRAIN_STEP_EVENT_KEYS <= set(ev["attrs"])
        assert "packed_staleness" in ev["attrs"]
    assert len(tracer.events("train.repack")) == 3


def test_port_reads_the_reference_checkpoint(ref_run):
    """The reference's newest checkpoint, read by the port: the same
    steps, tree, words (uint32 -> int32 bit for bit), masters, moments,
    data state and plan as the reference reads back."""
    ours = CheckpointManager(ref_run["dir"])
    theirs = RefManager(ref_run["dir"])
    assert ours.all_steps() == theirs.all_steps() == [0, 1, 2]
    step, tree, plan = ours.restore(with_plan=True)
    rstep, rtree, rplan = theirs.restore(with_plan=True)
    assert step == rstep == 2
    assert plan.to_jsonable() == rplan.to_jsonable()
    want = _numpy_tree(rtree)

    def same(got, ref, path=""):
        if isinstance(ref, dict) and not isinstance(got, PackedTensor):
            assert set(got) == set(ref), path
            for k in ref:
                same(got[k], ref[k], f"{path}/{k}")
        elif isinstance(got, PackedTensor):
            assert got.bits == ref["bits"] and got.kind == ref["kind"]
            assert got.logical_shape == tuple(ref["logical_shape"])
            np.testing.assert_array_equal(
                got.data.numpy(), np.asarray(ref["data"]).view(np.int32))
        else:
            ref = np.asarray(ref)
            if ref.dtype == np.uint32:
                ref = ref.view(np.int32)
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=path)

    same(tree, want)
    assert isinstance(rtree["packed"]["embed"], RefPacked)


# ---------------------------------------------------------------------------
# the manager itself
# ---------------------------------------------------------------------------

def test_manager_atomic_keep_async_and_bf16(tmp_path):
    d = str(tmp_path)
    os.makedirs(os.path.join(d, "step_000009.tmp-stale"))
    mgr = CheckpointManager(d, keep=2)
    assert not any(".tmp-" in n for n in os.listdir(d))     # collected
    w = torch.randn(4, 40).to(torch.bfloat16)
    tree = {"w": w, "p": pack_tensor(torch.randn(3, 40), 12),
            "n": [torch.arange(3), {"s": 7}]}
    saved = []
    for step in range(3):
        mgr.save(step, tree, blocking=False, plan=None)
        saved.append(w.clone())
        w.add_(1)                  # in place, right after the save
    mgr.wait()
    assert mgr.all_steps() == [1, 2] and mgr.latest_step() == 2
    step, got, plan = mgr.restore(with_plan=True)
    assert plan is None and step == 2
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"], saved[2])
    assert got["p"].bits == 12 and torch.equal(got["p"].data,
                                                tree["p"].data)
    assert torch.equal(got["n"][0], torch.arange(3))
    assert int(got["n"][1]["s"]) == 7
    with open(os.path.join(d, "step_000002", "manifest.json")) as f:
        manifest = json.load(f)
    assert set(manifest) == {"step", "leaves", "treedef_json", "plan"}
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_trains_packed_with_checkpoints_and_events(tmp_path,
                                                            capsys):
    events = tmp_path / "events.jsonl"
    launcher.main(["--arch", "qwen3_8b", "--reduced", "--steps", "3",
                   "--device", "cpu", "--pack-params", "--checkpoint-dir",
                   str(tmp_path / "ckpt"), "--metrics-out", str(events),
                   "--seq-len", "32"])
    out = capsys.readouterr().out
    assert "final loss: " in out and "steps: 3  stragglers: 0" in out
    recs = [json.loads(line) for line in events.read_text().splitlines()]
    names = [r["name"] for r in recs]
    assert names.count("train.step") == 3 and names[-1] == "train.metrics"
    assert set(recs[-1]["attrs"]) == obs.TRAIN_FINAL_KEYS
    assert CheckpointManager(str(tmp_path / "ckpt")).latest_step() == 2


def test_launcher_trains_dense_on_the_cpu(capsys):
    launcher.main(["--arch", "deepseek_moe_16b", "--reduced", "--steps",
                   "2", "--device", "cpu", "--seq-len", "16"])
    assert "steps: 2" in capsys.readouterr().out


def test_launcher_multi_pod_needs_reduced(capsys):
    with pytest.raises(SystemExit) as e:
        launcher.main(["--arch", "qwen3_8b", "--multi-pod", "--device",
                       "cpu"])
    assert e.value.code == 2
    assert "A15" in capsys.readouterr().err


def test_trainer_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(cfg_of(), TrainConfig(steps=1))
