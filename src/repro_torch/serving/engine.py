"""Batched greedy decode serving with packed weights and a packed KV cache.

Port of the dense-KV mode of ``repro.serving.engine.ServeEngine``:

  * the residency planner (``core.occupancy.decode_residency``, H100 by
    default) sizes the slot count unless ``max_slots`` is given;
  * continuous batching: deque admission into free slots;
  * chunked prefill: admitted prompts stream through ``lm.prefill_step``
    ``prefill_chunk`` tokens at a time (chunk widths bucketed to powers
    of two), leaving one token per request for the first decode tick;
  * one ``decode_step`` over the whole slot array per tick, then greedy
    argmax (one device-to-host read of the tokens per tick).

``pack_weights=True`` (or a ``plan``) packs the weights at the planned
width (``uniform_plan`` + ``repack``); on the card the packing itself
runs through the ``pack`` kernel. ``params=`` serves given parameters
(parity runs pass the reference's, converted by ``interop``); otherwise
they come from ``LM.init`` with seed 0. Paged KV (ROADMAP A10), sampling
and plans with per-layer KV widths (ROADMAP A11) raise
``NotImplementedError``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Deque, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.compress import repack, uniform_plan
from repro_torch.core.occupancy import H100, decode_residency
from repro_torch.core.tensor_store import tree_bytes, tree_to, weight_pass_bytes
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM

BOS_TOKEN = 0          # fed when a request has no prompt
MAX_RESULTS = 65536    # finished outputs kept (FIFO)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int = 16
    output: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    done: bool = False
    submitted_at: float = 0.0
    finished_at: float = 0.0


@dataclasses.dataclass
class ServeEngine:
    cfg: ModelConfig
    max_seq_len: int = 256
    max_slots: Optional[int] = None
    greedy: bool = True
    pack_weights: bool = False     # pack params at the planned width
    prefill_chunk: int = 16        # prompt tokens ingested per prefill call
    plan: Optional[Any] = None     # a per-leaf CompressionPlan
    paged: bool = False
    tracer: Optional[obs.Tracer] = None
    params: Optional[Dict] = None  # serve these instead of LM.init's
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        if self.paged:
            raise NotImplementedError(
                "paged KV serving is not ported yet (ROADMAP A10)")
        if not self.greedy:
            raise NotImplementedError(
                "sampled decoding is not ported yet (ROADMAP A11)")
        if self.plan is not None and getattr(self.plan, "kv_bits", None):
            raise NotImplementedError(
                "plans with per-layer KV widths are not ported yet "
                "(ROADMAP A11)")
        if self.tracer is None:
            self.tracer = obs.default_tracer()
        self.lm = LM(self.cfg, device=self.device)
        self.device = self.lm.device
        if self.params is None:
            self.params = self.lm.init()
        else:
            self.params = tree_to(self.params, self.device)
        self.weight_plan = None
        if self.pack_weights or self.plan is not None:
            self.weight_plan = self.plan or uniform_plan(
                self.params, self.cfg.resolved_weight_bits)
            self.params = repack(self.params, self.weight_plan)
        self._pass_bytes = weight_pass_bytes(self.params)
        self._kv_bytes_per_row = self.cfg.kv_bytes_per_token()
        weight_bytes = self.cfg.n_params() * (
            self.cfg.resolved_weight_bits // 8)
        self.residency = decode_residency(
            weight_bytes=weight_bytes,
            kv_bytes_per_token=self.cfg.kv_bytes_per_token(),
            seq_len=self.max_seq_len, chip=H100)
        self.n_slots = self.max_slots or max(
            min(self.residency.max_sequences, 64), 1)
        self.state = self.lm.init_decode_state(self.n_slots,
                                               self.max_seq_len)
        self._free: Deque[int] = collections.deque(range(self.n_slots))
        self._active: Dict[int, Request] = {}
        self._results: Dict[int, List[int]] = {}
        self._queue: Deque[Request] = collections.deque()
        self._next_rid = 0
        self._last_tokens = np.zeros((self.n_slots, 1), np.int64)
        self._pending_prefill: Dict[int, List[int]] = {}
        self.ticks = 0
        self.tokens_out = 0
        self._decode_calls = 0
        self._prefill_calls = 0
        self._weight_passes = 0
        self._kv_rows_appended = 0
        self._kv_rows_committed = 0
        self._finished_total = 0
        self._admitted_total = 0
        self._admission_wait_sum = 0.0

    # -- client API -----------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16) -> int:
        # prompt + all-but-the-last generated token must fit the cache;
        # past max_seq_len the append would clamp onto the last row
        need = max(len(prompt), 1) + max_new_tokens - 1
        if need > self.max_seq_len:
            raise ValueError(
                f"request needs {need} KV rows (prompt {len(prompt)} + "
                f"{max_new_tokens} new) but max_seq_len is "
                f"{self.max_seq_len} [dense KV mode]")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid=rid, prompt=list(prompt),
                                   max_new_tokens=max_new_tokens,
                                   submitted_at=time.perf_counter()))
        self._admit()
        return rid

    def result(self, rid: int) -> Optional[List[int]]:
        return self._results.get(rid)

    @property
    def occupancy(self) -> float:
        return (self.n_slots - len(self._free)) / self.n_slots

    @property
    def weight_read_bytes(self) -> int:
        """Bytes one full weight pass streams (packed where packed)."""
        return tree_bytes(self.params)[0]

    # -- scheduler ------------------------------------------------------------
    def _reset_slot(self, slot: int) -> None:
        """Recycle a slot: zero its cache length (rows past len are dead)."""
        self.state["len"][slot] = 0

    def _admit(self) -> None:
        admitted = False
        while self._queue and self._free:
            req = self._queue.popleft()
            slot = self._free.popleft()
            req.slot = slot
            self._active[req.rid] = req
            admitted = True
            wait = time.perf_counter() - req.submitted_at
            self._admitted_total += 1
            self._admission_wait_sum += wait
            obs.REGISTRY.histogram(
                "serve_admission_wait_seconds",
                "Submit-to-admit wait per request.",
            ).observe(wait)
            self.tracer.event("serve.admit", rid=req.rid, slot=slot,
                              wait_s=wait, prompt_len=len(req.prompt))
            self._reset_slot(slot)
            # an empty prompt still needs one deterministic first token
            self._pending_prefill[req.rid] = (list(req.prompt)
                                              or [BOS_TOKEN])
        if admitted:
            self._ingest_prompts()

    def _ingest_prompts(self) -> None:
        """Stream pending prompts through ``lm.prefill_step`` in chunks,
        leaving exactly one token pending per request for the next decode
        tick. Slots not prefilling ride along with n_valid = 0."""
        while True:
            pending = {rid: toks for rid, toks in self._pending_prefill.items()
                       if len(toks) > 1 and rid in self._active}
            if not pending:
                return
            need = min(self.prefill_chunk,
                       max(len(t) - 1 for t in pending.values()))
            chunk = 1
            while chunk < need:
                chunk *= 2
            chunk = min(chunk, self.prefill_chunk)
            tokens = np.zeros((self.n_slots, chunk), np.int64)
            n_valid = np.zeros((self.n_slots,), np.int32)
            for rid, toks in pending.items():
                req = self._active[rid]
                take = min(chunk, len(toks) - 1)
                tokens[req.slot, :take] = toks[:take]
                n_valid[req.slot] = take
                del toks[:take]
            rows = int(n_valid.sum())
            self._kv_rows_appended += rows
            self._kv_rows_committed += rows
            with self.tracer.span("serve.prefill", chunk=chunk, rows=rows,
                                  requests=len(pending)):
                self._prefill_calls += 1
                self._weight_passes += 1
                self.state = self.lm.prefill_step(
                    self.params, self.state,
                    torch.from_numpy(tokens).to(self.device),
                    torch.from_numpy(n_valid).to(self.device))

    def _generate(self) -> Dict[int, List[int]]:
        """One decode tick: the token committed per request id."""
        tokens = self._last_tokens.copy()
        for req in self._active.values():
            pend = self._pending_prefill.get(req.rid)
            if pend:
                tokens[req.slot, 0] = pend.pop(0)
        self._decode_calls += 1
        self._weight_passes += 1
        rows = len(self._active)
        self._kv_rows_appended += rows
        self._kv_rows_committed += rows
        with self.tracer.span("serve.decode", requests=rows):
            logits, self.state = self.lm.decode_step(
                self.params, self.state,
                torch.from_numpy(tokens).to(self.device))
            nxt = logits[:, 0, :].argmax(dim=-1).cpu().numpy()
        out: Dict[int, List[int]] = {}
        for req in self._active.values():
            if self._pending_prefill.get(req.rid):
                continue                   # still prefilling: ignore sample
            out[req.rid] = [int(nxt[req.slot])]
        self._last_tokens = nxt[:, None].astype(np.int64)
        return out

    def step(self) -> int:
        """One tick for every resident sequence; returns the tokens
        emitted to outputs this tick."""
        if not self._active:
            return 0
        with self.tracer.span("serve.tick", tick=self.ticks) as sp:
            committed = self._generate()
            emitted = 0
            finished: List[int] = []
            for rid, toks in committed.items():
                req = self._active[rid]
                take = toks[:req.max_new_tokens - len(req.output)]
                req.output.extend(take)
                emitted += len(take)
                if len(req.output) >= req.max_new_tokens:
                    req.done = True
                    req.finished_at = time.perf_counter()
                    finished.append(rid)
            for rid in finished:
                req = self._active.pop(rid)
                self._results[rid] = req.output
                self._free.append(req.slot)
                self._pending_prefill.pop(rid, None)
            self._finished_total += len(finished)
            while len(self._results) > MAX_RESULTS:
                self._results.pop(next(iter(self._results)))
            self._admit()
            self.ticks += 1
            self.tokens_out += emitted
            sp["emitted"] = emitted
            sp["finished"] = len(finished)
        return emitted

    # -- observability --------------------------------------------------------
    def metrics_snapshot(self) -> Dict[str, Any]:
        """Point-in-time stats from host-side counters; the key set is
        ``obs.snapshot_keys()``, the reference's dense set."""
        return {
            "ticks": self.ticks,
            "tokens": self.tokens_out,
            "slots": self.n_slots,
            "active_requests": len(self._active),
            "queued_requests": len(self._queue),
            "finished_requests": self._finished_total,
            "admitted_requests": self._admitted_total,
            "admission_wait_s_mean": (
                self._admission_wait_sum / self._admitted_total
                if self._admitted_total else 0.0),
            "slot_occupancy": self.occupancy,
            "residency_max_sequences": self.residency.max_sequences,
            "arithmetic_intensity": self.residency.arithmetic_intensity,
            "decode_calls": self._decode_calls,
            "prefill_calls": self._prefill_calls,
            "weight_passes": self._weight_passes,
            "weight_read_bytes_fused":
                self._weight_passes * self._pass_bytes["fused"],
            "weight_read_bytes_dense":
                self._weight_passes * self._pass_bytes["dense"],
            "fused_bytes_per_pass": self._pass_bytes["fused"],
            "fused_analytic_bytes_per_pass": self._pass_bytes["analytic"],
            "fused_f32_bytes_per_pass": self._pass_bytes["fused_f32"],
            "dense_bytes_per_pass": self._pass_bytes["dense"],
            "kv_rows_appended": self._kv_rows_appended,
            "kv_rows_committed": self._kv_rows_committed,
            "kv_bytes_appended":
                self._kv_rows_appended * self._kv_bytes_per_row,
        }

    def run_until_drained(self, max_ticks: int = 10000) -> Dict[str, Any]:
        t0 = time.perf_counter()
        while (self._queue or self._active) and self.ticks < max_ticks:
            self.step()
        stats: Dict[str, Any] = self.metrics_snapshot()
        self.tracer.event("serve.metrics", **stats)
        stats["wall_s"] = time.perf_counter() - t0
        return stats
