"""Training loop: microbatched, checkpointed, watchdogged.

Port of ``repro.train.loop``. A host loop drives one step function
(``make_train_step``) and owns fault tolerance: periodic asynchronous
checkpoints, a checkpoint on preemption, straggler observation and a
restart-exact data stream (batches keyed by step). The step runs
eagerly: no ``torch.compile``, no jit.

**Packed-master mode** (``TrainConfig.pack_params``): the float
parameters live as ``PackedTensor`` codes for every forward and
backward. The loss runs the model on an ``STWeight`` tree (``st_tree``:
codes forward, straight-through dW to the dense masters the optimizer
owns), so the forward and the fused dx backward both stream the packed
words through the kernels (``models.layers``): a step's weight reads
are 2 x bits/32 of the f32 stream, and dW reads no weights. After the
AdamW update the masters re-encode to their plan width every
``repack_every`` steps (``optim.repack_params``); in between the codes
go stale by at most the masters' drift (``optim.packed_staleness``,
logged). Checkpoints carry the (codes, masters, plan) triple, and a
resumed run is bitwise equal to an uninterrupted one.

Differences from the reference, by design: microbatches are a Python
loop that accumulates gradients; no layer is rematerialized (the
reference's ``jax.checkpoint`` changes memory, not values); the
optimizer updates parameters and moments in place; the data stream
matches the reference's in distribution only.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Union

import torch

from repro_torch import obs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.compress import (CompressionPlan, repacked_copy,
                                       uniform_plan)
from repro_torch.core.tensor_store import (is_packed, st_tree, tree_leaves,
                                           tree_map_with_path, tree_to,
                                           weight_pass_bytes)
from repro_torch.data import SyntheticTokens
from repro_torch.distributed.grad_compress import (apply_error_feedback,
                                                   init_error_feedback)
from repro_torch.kernels import ops as kops
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, packed_staleness,
                               repack_params)
from repro_torch.train.watchdog import PreemptionGuard, StragglerWatchdog


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    steps: int = 100
    seq_len: int = 512
    global_batch: int = 8
    microbatches: int = 1
    lr: float = 3e-4
    warmup: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    grad_compress_bits: Optional[int] = None   # error-feedback width
    seed: int = 0
    # packed-master training: params live as PackedTensor codes for every
    # forward/backward; dense masters belong to the optimizer and
    # re-encode to the plan width every repack_every steps.
    pack_params: bool = False
    repack_every: int = 1
    # packed-master plan source: a plan JSON (the reference's schema).
    # None keeps the uniform plan at the config's resolved width. A
    # checkpoint's manifest plan still wins on resume.
    plan_path: Optional[str] = None
    # observability: a JSONL sink for the train.step / train.repack /
    # train.metrics events and the step cadence of train.step.
    metrics_out: Optional[str] = None
    metrics_interval: int = 1


def _grad_loop(loss_fn: Callable, diff_arg: Any, batch: Dict,
               tc: TrainConfig):
    """(loss, grads) w.r.t. every tensor leaf of ``diff_arg``: grads is a
    tree like it (a leaf the loss does not reach gets zeros). With
    ``tc.microbatches`` > 1 the batch splits into that many row blocks
    whose losses and f32 grads are averaged, as the reference's scan
    does."""
    leaves = list(tree_leaves(diff_arg))

    def one(b):
        loss = loss_fn(diff_arg, b)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for g, p in zip(grads, leaves)]

    if tc.microbatches > 1:
        mb = tc.microbatches
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        for i in range(mb):
            part = {k: v[i * (v.shape[0] // mb):(i + 1) * (v.shape[0] // mb)]
                    for k, v in batch.items()}
            l, gs = one(part)
            loss = loss + l / mb
            acc = [a + g / mb for a, g in zip(acc, gs)]
        grads = acc
    else:
        loss, grads = one(batch)
    it = iter(grads)
    return loss, tree_map_with_path(lambda _, __: next(it), diff_arg)


def make_train_step(lm: LM, opt_cfg: AdamWConfig, tc: TrainConfig):
    """Dense mode: train_step(params, opt_state, ef, batch, step) ->
    (params, opt_state, ef, loss).

    Packed-master mode (``tc.pack_params``): train_step(packed, masters,
    opt_state, ef, batch, step) -> (packed, masters, opt_state, ef,
    loss). The loss runs the model on ``st_tree(packed, masters)``; AdamW
    updates the masters in place; every ``tc.repack_every``-th step the
    planned leaves re-encode from them (off-steps keep the stale
    codes)."""
    if tc.pack_params and tc.repack_every < 1:
        raise ValueError(
            f"repack_every must be >= 1, got {tc.repack_every}; use a "
            "value >= total steps to effectively never repack")

    def update(diff_arg, loss_fn, opt_state, ef_state, batch, step):
        loss, grads = _grad_loop(loss_fn, diff_arg, batch, tc)
        grads, ef_state = apply_error_feedback(grads, ef_state,
                                               tc.grad_compress_bits)
        lr = cosine_schedule(step, tc.lr, tc.warmup, tc.steps)
        diff_arg, opt_state = adamw_update(grads, opt_state, diff_arg,
                                           opt_cfg, lr)
        return diff_arg, opt_state, ef_state, loss

    def train_step(params, opt_state, ef_state, batch, step):
        return update(params, lm.loss, opt_state, ef_state, batch, step)

    def packed_train_step(packed, masters, opt_state, ef_state, batch,
                          step):
        masters, opt_state, ef_state, loss = update(
            masters, lambda ms, b: lm.loss(st_tree(packed, ms), b),
            opt_state, ef_state, batch, step)
        if (step + 1) % tc.repack_every == 0:
            packed = repack_params(packed, masters)
        return packed, masters, opt_state, ef_state, loss

    return packed_train_step if tc.pack_params else train_step


@dataclasses.dataclass
class Trainer:
    cfg: ModelConfig
    tc: TrainConfig
    opt_cfg: Optional[AdamWConfig] = None
    tracer: Optional[obs.Tracer] = None
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        if self.tracer is None:
            if self.tc.metrics_out:
                self.tracer = obs.Tracer(sink=self.tc.metrics_out)
            else:
                self.tracer = obs.default_tracer()
        self.lm = LM(self.cfg, device=self.device)
        self.device = self.lm.device
        comp = self.cfg.compression
        self.opt_cfg = self.opt_cfg or AdamWConfig(
            lr=self.tc.lr, m_bits=comp.opt_m_bits, v_bits=comp.opt_v_bits)
        self.data = SyntheticTokens(
            vocab_size=self.cfg.vocab_size, seq_len=self.tc.seq_len,
            global_batch=self.tc.global_batch, seed=self.tc.seed)
        self.watchdog = StragglerWatchdog()
        self.ckpt = (CheckpointManager(self.tc.checkpoint_dir)
                     if self.tc.checkpoint_dir else None)
        self.plan: Optional[CompressionPlan] = None
        self.state: Optional[Dict[str, Any]] = None    # set by run()
        # step_launches: kernel launches of each step, its staleness
        # probe included (kernels.ops.launch_counts; 0 on the CPU)
        self.metrics: Dict[str, Any] = {"losses": [], "step_times": [],
                                        "staleness": [], "step_launches": []}

    def _extra_inputs(self, b: int) -> Dict[str, torch.Tensor]:
        """The inputs past the tokens: the vlm's zero patch embeddings,
        encdec's zero frames."""
        cfg, extra = self.cfg, {}
        if cfg.family == "vlm":
            extra["patch_embeds"] = torch.zeros(
                (b, cfg.num_image_tokens, cfg.d_model), device=self.device)
        if cfg.family == "encdec":
            extra["frames"] = torch.zeros(
                (b, cfg.encoder_seq, cfg.d_model), device=self.device)
        return extra

    def _build_packed(self, params):
        """(packed, masters) for packed-master mode: the plan (from
        ``plan_path``, else uniform at the config's resolved width)
        packs every float leaf it names; the packed tree mirrors the
        params (unplanned riders copied, so the trees share no tensor);
        the masters are the params themselves."""
        if self.plan is None and self.tc.plan_path:
            self.plan = CompressionPlan.load(self.tc.plan_path)
        self.plan = self.plan or uniform_plan(
            params, self.cfg.resolved_weight_bits)
        with torch.no_grad():
            packed = tree_map_with_path(
                lambda _, l: l if is_packed(l) else l.clone(),
                repacked_copy(params, self.plan))
        return packed, params

    def run(self, resume: bool = True,
            install_signals: bool = False) -> Dict[str, Any]:
        tc = self.tc
        gen = torch.Generator(device=self.device).manual_seed(tc.seed)
        params = self.lm.init(gen)
        packed = None
        opt_state = adamw_init(params, self.opt_cfg)
        ef = init_error_feedback(params) if tc.grad_compress_bits else 0
        start_step = 0

        if resume and self.ckpt and self.ckpt.latest_step() is not None:
            if tc.pack_params:
                step, tree, plan = self.ckpt.restore(with_plan=True)
                packed = tree_to(tree["packed"], self.device)
                params = tree_to(tree["masters"], self.device)
                self.plan = plan or uniform_plan(
                    params, self.cfg.resolved_weight_bits)
            else:
                step, tree = self.ckpt.restore()
                params = tree_to(tree["params"], self.device)
            opt_state = tree_to(tree["opt"], self.device)
            self.data.load_state_dict(tree["data"])
            start_step = step + 1
        elif tc.pack_params:
            # a fresh packed-master start encodes the params once (a
            # resumed run restores the codes instead)
            packed, params = self._build_packed(params)
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)

        step_fn = make_train_step(self.lm, self.opt_cfg, tc)
        guard = PreemptionGuard(install=install_signals)
        # packed-master steps stream the codes twice (forward and fused
        # dx backward; dW reads no weights)
        pass_bytes = weight_pass_bytes(packed if tc.pack_params else params)
        repacks = 0
        interval = max(tc.metrics_interval, 1)
        step = start_step - 1
        try:
            for step in range(start_step, tc.steps):
                before = kops.launch_counts()
                t0 = time.perf_counter()
                batch = self.data.batch_at(step)
                feed = {k: v.to(self.device) for k, v in batch.as_dict(
                    self._extra_inputs(batch.tokens.shape[0])).items()}
                if tc.pack_params:
                    packed, params, opt_state, ef, loss = step_fn(
                        packed, params, opt_state, ef, feed, step)
                else:
                    params, opt_state, ef, loss = step_fn(
                        params, opt_state, ef, feed, step)
                loss = float(loss)            # waits for the device
                dt = time.perf_counter() - t0
                self.watchdog.observe(step, dt)
                self.metrics["losses"].append(loss)
                self.metrics["step_times"].append(dt)
                last = step + 1 == tc.steps
                stale = None
                if tc.pack_params and ((step + 1) % tc.log_every == 0
                                       or last):
                    stale = packed_staleness(packed, params)
                    self.metrics["staleness"].append((step, stale))
                after = kops.launch_counts()
                self.metrics["step_launches"].append(
                    {k: after[k] - before[k] for k in after})
                obs.REGISTRY.histogram(
                    "train_step_seconds", "Wall time per train step.",
                ).observe(dt)
                obs.REGISTRY.gauge(
                    "train_loss", "Most recent train-step loss.").set(loss)
                if tc.pack_params and (step + 1) % tc.repack_every == 0:
                    repacks += 1
                    self.tracer.event("train.repack", step=step,
                                      repack_every=tc.repack_every)
                if (step + 1) % interval == 0 or last:
                    attrs = {"step": step, "loss": loss, "step_time_s": dt}
                    if stale is not None:
                        attrs["packed_staleness"] = stale
                    self.tracer.event("train.step", **attrs)
                if self.ckpt and ((step + 1) % tc.checkpoint_every == 0
                                  or guard.requested or last):
                    self.data.step = step + 1
                    if tc.pack_params:
                        tree = {"packed": packed, "masters": params,
                                "opt": opt_state,
                                "data": self.data.state_dict()}
                    else:
                        tree = {"params": params, "opt": opt_state,
                                "data": self.data.state_dict()}
                    self.ckpt.save(step, tree, blocking=False,
                                   plan=self.plan)
                if guard.requested:
                    break
        finally:
            guard.restore()
            if self.ckpt:
                self.ckpt.wait()
        # the trained trees, for the caller (the reference keeps them
        # only in its checkpoints)
        self.state = {"packed": packed, "params": params, "opt": opt_state}
        return self._finish(step, repacks, pass_bytes)

    def _finish(self, step: int, repacks: int,
                pass_bytes: Dict[str, int]) -> Dict[str, Any]:
        """The run's metrics, and the final ``train.metrics`` event with
        exactly ``obs.schema.TRAIN_FINAL_KEYS``: 2 weight passes a step
        (forward and fused dx backward)."""
        m = self.metrics
        steps_done = len(m["losses"])
        m["final_loss"] = m["losses"][-1] if steps_done else None
        m["straggler_events"] = self.watchdog.events
        m["last_step"] = step if steps_done else -1
        passes = 2 * steps_done
        final = {
            "steps_completed": steps_done,
            "last_step": m["last_step"],
            "final_loss": m["final_loss"],
            "mean_step_time_s": (sum(m["step_times"]) / steps_done
                                 if steps_done else 0.0),
            "repacks": repacks,
            "straggler_events": self.watchdog.events,
            "weight_passes": passes,
            "weight_read_bytes_fused": passes * pass_bytes["fused"],
            "weight_read_bytes_dense": passes * pass_bytes["dense"],
            "fused_analytic_bytes_per_pass": pass_bytes["analytic"],
        }
        self.tracer.event("train.metrics", **final)
        self.tracer.flush()
        for key, val in final.items():
            m.setdefault(key, val)
        return m
