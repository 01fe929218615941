"""Narrow-draft self-speculative decoding.

Port of ``repro.serving.speculative``. A **draft** derivation of the
same model (its weights re-encoded one Table 3 ladder step down by
``core.compress.derive_plan`` + ``repacked_copy``, never re-tuned)
proposes ``k`` tokens a tick through its own decode state; the
full-width **target** scores all ``k+1`` positions in one
``LM.verify_step`` call. The greedy prefix rule (or rejection sampling,
when sampling) commits the longest agreeing prefix plus one target
token, then both caches roll back to the committed length
(``LM.rollback_decode_state``, a length reset). Greedy output is the
plain engine's token for token.

The draft's weights are packed trees at the draft width, so its
``linear``s run ``packed_matmul`` (and its expert banks
``packed_matmul_batched``) at that width; no draft weight is decoded to
device memory. Its KV cache packs at ``draft_kv_bits`` (one rung below
the target's ``kv_bits`` by default), per layer when the target has
``kv_layer_bits``. In paged mode the draft's pools mirror the target's
page ids and share its device page table.

Each tick the draft runs ``k`` decode steps and one more body that only
appends d_k's KV row (no head product: the reference's jitted scan drops
those logits as dead code), and the target ``k+1`` decode steps. The
port has no jit, so the reference's compiled draft loop is a Python
loop here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.compress import derive_plan, repacked_copy, uniform_plan
from repro_torch.core.formats import FLOAT_LADDER, ladder_snap
from repro_torch.core.tensor_store import tree_bytes, weight_pass_bytes
from repro_torch.models.lm import LM, Refused
from repro_torch.serving.engine import (ServeEngine, _pool_copy_page,
                                        fold_in, sample_per_slot)

DRAFT_SALT = 0x0D4AF7   # the draft stream's salt off the tick key


@dataclasses.dataclass
class DraftController:
    """Adaptive retuning of the draft's (width, k) from live acceptance:
    an EWMA of each window's acceptance rate (accepted / proposed), and
    once a window holds ``min_proposals`` proposals,

    * **widen** one Table 3 rung when the EWMA falls below ``floor``, or
      at the widest legal rung (one below the target) **shrink k** down
      to ``min_k``;
    * **narrow** one rung when the EWMA exceeds ``ceiling``, floored at
      AF8.

    ``k`` never grows: admission reserved headroom for the initial k.
    Retuning re-encodes draft weights only, so it moves acceptance,
    never the emitted tokens."""

    floor: float = 0.5          # EWMA below this: widen (or shrink k)
    ceiling: float = 0.95       # EWMA above this: narrow
    alpha: float = 0.5          # EWMA weight of the newest window
    min_proposals: int = 64     # proposals per decision window
    min_k: int = 1

    def __post_init__(self):
        if not (0.0 <= self.floor < self.ceiling <= 1.0):
            raise ValueError(
                f"need 0 <= floor < ceiling <= 1, got "
                f"({self.floor}, {self.ceiling})")
        if self.min_proposals < 1:
            raise ValueError("min_proposals must be >= 1")

    def update(self, ewma: Optional[float], rate: float) -> float:
        return rate if ewma is None else (
            self.alpha * rate + (1 - self.alpha) * ewma)

    def decide(self, ewma: float, draft_bits: int, k: int,
               wbits: int) -> Optional[Tuple[str, int]]:
        """-> ("widen" | "narrow", bits) | ("shrink_k", k) | None."""
        if ewma < self.floor:
            wider = next((r for r in FLOAT_LADDER
                          if draft_bits < r < wbits), None)
            if wider is not None:
                return ("widen", wider)
            if k > self.min_k:
                return ("shrink_k", k - 1)
            return None
        if ewma > self.ceiling and draft_bits > FLOAT_LADDER[0]:
            return ("narrow", ladder_snap(draft_bits, below=True))
        return None


def resolve_draft_bits(cfg) -> int:
    """Draft width: the config's ``draft_weight_bits``, else one Table 3
    ladder step below the target's planned weight width."""
    comp = cfg.compression
    if comp.draft_weight_bits:
        return comp.draft_weight_bits
    return ladder_snap(cfg.resolved_weight_bits, below=True)


def resolve_draft_kv_bits(cfg) -> Optional[int]:
    """Draft KV width: the ``draft_kv_bits`` knob, else one rung below
    the target's ``kv_bits`` when the target packs its KV; a dense-KV
    target keeps a dense draft cache (None)."""
    comp = cfg.compression
    if comp.draft_kv_bits:
        return ladder_snap(comp.draft_kv_bits)
    if comp.kv_bits:
        return ladder_snap(comp.kv_bits, below=True)
    return None


@dataclasses.dataclass
class SpeculativeEngine(ServeEngine):
    """``ServeEngine`` with the speculative tick. Requests need ``k``
    rows of ``max_seq_len`` headroom past the plain engine's prompt +
    max_new_tokens - 1: speculated rows are appended before the
    roll-back."""

    k: int = 4                          # drafted tokens per tick
    draft_bits: Optional[int] = None    # override the config knob
    draft_kv_bits: Optional[int] = None  # override the draft-KV knob
    adaptive: bool = False              # retune (width, k) from acceptance
    controller: Optional[DraftController] = None

    def __post_init__(self):
        super().__post_init__()
        if self.k < 1:
            raise Refused(f"k must be >= 1, got {self.k}")
        if not self.lm.supports_rollback:
            mode = "paged KV mode" if self.paged else "dense KV mode"
            raise Refused(
                f"family {self.cfg.family!r} cannot roll its decode state "
                f"back; speculation needs KV-length rollback [{mode}]")
        wbits = self.cfg.resolved_weight_bits
        # snapped to the ladder before it is checked or reported: the
        # packed store only has Table 3 rungs
        dbits = ladder_snap(self.draft_bits or resolve_draft_bits(self.cfg))
        if dbits >= wbits:
            raise Refused(
                f"draft width {dbits} (ladder-snapped) must be narrower "
                f"than the target's {wbits}")
        self.draft_bits = dbits
        # the draft's plan steps the target's down; its tree re-encodes
        # the target's leaves into fresh containers (the port's repack
        # works in place), so the target keeps its weights. The base plan
        # stays for the controller's re-derivations.
        self._base_plan = self.weight_plan or uniform_plan(self.params,
                                                           wbits)
        self.draft_plan = derive_plan(self._base_plan, wbits - dbits)
        self.draft_params = repacked_copy(self.params, self.draft_plan)
        explicit_draft_kv = (self.draft_kv_bits is not None
                             or bool(self.cfg.compression.draft_kv_bits))
        if self.draft_kv_bits is None:
            self.draft_kv_bits = resolve_draft_kv_bits(self.cfg)
        elif self.draft_kv_bits:
            self.draft_kv_bits = ladder_snap(self.draft_kv_bits)
        tgt_kv = self.cfg.compression.kv_bits
        if self.draft_kv_bits and tgt_kv and self.draft_kv_bits > tgt_kv:
            raise Refused(
                f"draft KV width {self.draft_kv_bits} (ladder-snapped) "
                f"must not be wider than the target's {tgt_kv}")
        draft_klb = None
        if (self.cfg.compression.kv_layer_bits is not None
                and self.draft_kv_bits and not explicit_draft_kv):
            # a mixed-width target: each draft layer one rung below its
            # own width; the scalar draft_kv_bits is their max
            draft_klb = tuple(ladder_snap(b, below=True)
                              for b in self.cfg.compression.kv_layer_bits)
            self.draft_kv_bits = max(draft_klb)
            if len(set(draft_klb)) <= 1:
                draft_klb = None          # uniform after all: the scalar
        self.draft_cfg = dataclasses.replace(
            self.cfg, compression=dataclasses.replace(
                self.cfg.compression, kv_bits=self.draft_kv_bits,
                kv_layer_bits=draft_klb))
        self.draft_lm = LM(self.draft_cfg, device=self.device,
                           paged_attn=self.paged_attn)
        if self.paged:
            # the same page ids as the target's pools, its own buffers;
            # one pool allocator and one device table (the target's
            # tensor, updated in place) govern both
            self.draft_state = self.draft_lm.init_paged_decode_state(
                self.n_slots, self.max_seq_len, self.kv_page_size,
                self.kv_pool_pages)
            self.draft_state["table"] = self.state["table"]
        else:
            self.draft_state = self.draft_lm.init_decode_state(
                self.n_slots, self.max_seq_len)
        if self.cfg.family == "encdec":
            self.draft_state["clen"].fill_(self.cfg.encoder_seq)
        self._one_row = torch.ones((self.n_slots,), dtype=torch.int32,
                                   device=self.device)
        self.spec_ticks = 0
        self.slot_ticks = 0
        self.proposed = 0
        self.accepted = 0
        if self.adaptive and self.controller is None:
            self.controller = DraftController()
        self._initial_k = self.k
        self._ewma: Optional[float] = None
        self._window_proposed = 0
        self._window_accepted = 0
        self.retune_events: List[Dict[str, Any]] = []
        # draft byte accounting: a retune changes the per-pass figures,
        # so the totals accrue at call time
        self._draft_pass_bytes = weight_pass_bytes(self.draft_params)
        self._draft_kv_bytes_per_row = self.draft_kv_bytes_per_token
        self._draft_weight_passes = 0
        self._draft_bytes_fused = 0
        self._draft_bytes_analytic = 0
        self._draft_bytes_dense = 0
        self._draft_kv_rows_appended = 0

    @property
    def _seq_headroom(self) -> int:
        # pinned at the initial k: the controller may shrink k, never
        # grow it past what admission reserved
        return self._initial_k

    # -- draft ---------------------------------------------------------------
    def _draft_k(self, params, state: Dict, t0: torch.Tensor):
        """t0 (B, 1) -> (drafts (B, k), draft logits (B, k, V) when
        sampling else None, state advanced k+1 rows). The last body only
        appends d_k's KV row, so the draft cache mirrors the target's
        input stream; it computes no logits."""
        lm, cur = self.draft_lm, t0
        key = self._tick_key(salt=DRAFT_SALT)
        drafts, dlogits = [], []
        for i in range(self.k):
            logits, state = lm.decode_step(params, state, cur)
            lg = logits[:, 0]
            nxt = (lg.argmax(dim=-1) if self.greedy else sample_per_slot(
                self._generator(fold_in(key, i)), lg))
            cur = nxt[:, None]
            drafts.append(nxt)
            dlogits.append(lg)
        state = lm.prefill_step(params, state, cur, self._one_row)
        return (torch.stack(drafts, dim=1),
                None if self.greedy else torch.stack(dlogits, dim=1), state)

    # -- the speculative tick ------------------------------------------------
    def _generate(self) -> Dict[int, List[int]]:
        tokens = self._last_tokens.copy()
        for req in self._active.values():
            pend = self._pending_prefill.get(req.rid)
            if pend:
                # chunked ingestion left one token: the slot's first real
                # input, fed to both models this tick
                tokens[req.slot, 0] = pend.pop(0)
        if self.paged:
            # the tick's peak: k+1 appends past the committed length
            for req in self._active.values():
                self._ensure_rows(req, min(req.kv_len + self.k + 1,
                                           self.max_seq_len))
            self._push_tables()
        lens = torch.stack([self.state["len"],
                            self.draft_state["len"]]).cpu().numpy()
        len0, dlen0 = lens.astype(np.int64)
        t0 = torch.from_numpy(tokens).to(self.device)

        # k decode bodies with a head, one without: k+1 draft passes
        self._count_draft_passes(self.k + 1)
        with self.tracer.span("serve.draft", k=self.k, bits=self.draft_bits):
            drafts, dlogits, self.draft_state = self._draft_k(
                self.draft_params, self.draft_state, t0)
        vt = torch.cat([t0, drafts], dim=1)                   # (B, k+1)
        self._decode_calls += 1
        self._weight_passes += 1                 # one full-width verify
        pages = self._count_pages_read(
            [r.kv_len for r in self._active.values()], self.k + 1)
        with self.tracer.span("serve.verify", positions=self.k + 1), \
                self._paged_attn_span(pages, self.k + 1):
            vlogits, self.state = self.lm.verify_step(self.params,
                                                      self.state, vt)
        peak_rows = (self.k + 1) * len(self._active)
        self._kv_rows_appended += peak_rows
        self._draft_kv_rows_appended += peak_rows

        if self.greedy:
            # one host read: the drafts beside the target's argmax
            both = torch.cat([drafts, vlogits.argmax(dim=-1)], dim=1)
            both = both.cpu().numpy()
            commit = self._accept_greedy(both[:, :self.k], both[:, self.k:])
        else:
            commit = self._accept_sampled(drafts.cpu().numpy(), drafts,
                                          vlogits, dlogits)

        out: Dict[int, List[int]] = {}
        commits = np.zeros((self.n_slots,), np.int64)
        last = self._last_tokens.copy()
        for req in self._active.values():
            b = req.slot
            toks = commit[b]
            req.draft_proposed += self.k
            req.draft_accepted += len(toks) - 1
            self.proposed += self.k
            self.accepted += len(toks) - 1
            self.slot_ticks += 1
            out[req.rid] = toks
            commits[b] = len(toks)
            last[b, 0] = toks[-1]
        # both caches back to the committed length; free slots back to
        # where they started
        self.state = self.lm.rollback_decode_state(self.state,
                                                   len0 + commits)
        self.draft_state = self.draft_lm.rollback_decode_state(
            self.draft_state, dlen0 + commits)
        if self.paged:
            # rows past the committed length are dead: their tail pages
            # go back to the reservation
            for req in self._active.values():
                req.kv_len = min(req.kv_len + int(commits[req.slot]),
                                 self.max_seq_len)
                self._trim_pages(req)
        self._last_tokens = last
        self._kv_rows_committed += int(commits.sum())
        self.spec_ticks += 1
        if self.adaptive:
            self._maybe_retune()
        return out

    def _count_draft_passes(self, n: int) -> None:
        """Accrue ``n`` draft weight passes at the figures in force."""
        self._draft_weight_passes += n
        self._draft_bytes_fused += n * self._draft_pass_bytes["fused"]
        self._draft_bytes_analytic += (
            n * self._draft_pass_bytes["analytic"])
        self._draft_bytes_dense += n * self._draft_pass_bytes["dense"]

    # -- adaptive retuning ----------------------------------------------------
    def _maybe_retune(self) -> None:
        """Fold the finished window into the EWMA and apply at most one
        ladder move, between ticks."""
        wp = self.proposed - self._window_proposed
        wa = self.accepted - self._window_accepted
        if wp < self.controller.min_proposals:
            return
        self._ewma = self.controller.update(self._ewma, wa / max(wp, 1))
        self._window_proposed = self.proposed
        self._window_accepted = self.accepted
        action = self.controller.decide(
            self._ewma, self.draft_bits, self.k,
            self.cfg.resolved_weight_bits)
        if action is None:
            return
        kind, val = action
        self.retune_events.append({
            "tick": self.spec_ticks,
            "action": kind,
            "from_bits": self.draft_bits,
            "to_bits": val if kind != "shrink_k" else self.draft_bits,
            "from_k": self.k,
            "to_k": val if kind == "shrink_k" else self.k,
            "ewma": self._ewma,
            "proposed": self.proposed,
            "accepted": self.accepted,
        })
        self.tracer.event("serve.retune", **self.retune_events[-1])
        obs.REGISTRY.counter(
            "serve_retune_total", "Draft-controller retunes by action.",
        ).inc(1, action=kind)
        if kind == "shrink_k":
            self._set_k(val)
        else:
            self._set_draft_bits(val)
        # the old operating point's evidence does not describe the new
        self._ewma = None

    def _set_draft_bits(self, bits: int) -> None:
        """Re-derive the draft at another rung from the target's leaves.
        The draft LM caches its layer views per parameter tree, so the
        draft gets a new tree (repacking the old one in place would
        leave it decoding through stale views). The draft cache keeps
        its width."""
        wbits = self.cfg.resolved_weight_bits
        if not bits < wbits:
            raise ValueError(
                f"retuned draft width {bits} must stay below {wbits}")
        self.draft_bits = bits
        self.draft_plan = derive_plan(self._base_plan, wbits - bits)
        self.draft_params = repacked_copy(self.params, self.draft_plan)
        self._draft_pass_bytes = weight_pass_bytes(self.draft_params)

    def _set_k(self, k: int) -> None:
        """Shrink the proposals per tick (never past the initial k)."""
        if not 1 <= k <= self._initial_k:
            raise ValueError(
                f"k must be in [1, {self._initial_k}], got {k}")
        self.k = k

    def _accept_greedy(self, drafts: np.ndarray,
                       cand: np.ndarray) -> List[List[int]]:
        """Longest agreeing prefix + the target's own next token:
        cand[b, i] is the target's token after [t0, d_1..d_i], valid
        while every earlier draft matched."""
        out: List[List[int]] = []
        for b in range(drafts.shape[0]):
            toks: List[int] = []
            for i in range(self.k):
                t = int(cand[b, i])
                toks.append(t)
                if t != int(drafts[b, i]):
                    break
            else:
                toks.append(int(cand[b, self.k]))   # bonus token
            out.append(toks)
        return out

    def _accept_sampled(self, drafts_np: np.ndarray, drafts: torch.Tensor,
                        vlogits: torch.Tensor,
                        dlogits: torch.Tensor) -> List[List[int]]:
        """Rejection sampling (Leviathan et al.): accept d_i with
        probability min(1, p_t / p_d), on a reject draw from the residual
        max(0, p_t - p_d): the committed stream follows the target's
        distribution. Only the drafted tokens' probabilities cross to
        the host up front; a vocabulary row crosses per rejection or
        bonus token. Host draws from (nonce, tick), as the reference's."""
        rng = np.random.default_rng((self._sample_nonce, self.ticks))
        pt = torch.softmax(vlogits.float(), dim=-1)
        pd = torch.softmax(dlogits.float(), dim=-1)
        idx = drafts[..., None].long()
        pt_tok = torch.gather(pt[:, :self.k], -1, idx)[..., 0].cpu().numpy()
        pd_tok = torch.gather(pd, -1, idx)[..., 0].cpu().numpy()
        out: List[List[int]] = []
        for b in range(drafts_np.shape[0]):
            toks: List[int] = []
            for i in range(self.k):
                d = int(drafts_np[b, i])
                ratio = pt_tok[b, i] / max(pd_tok[b, i], 1e-30)
                if rng.uniform() < ratio:
                    toks.append(d)
                    continue
                p_t = pt[b, i].double().cpu().numpy()
                resid = np.maximum(p_t - pd[b, i].double().cpu().numpy(),
                                   0.0)
                z = resid.sum()
                p = resid / z if z > 0 else p_t
                toks.append(int(rng.choice(p.shape[0], p=p / p.sum())))
                break
            else:
                bonus = pt[b, self.k].double().cpu().numpy()
                toks.append(int(rng.choice(bonus.shape[0],
                                           p=bonus / bonus.sum())))
            out.append(toks)
        return out

    # -- the draft cache follows the target's ---------------------------------
    def _prefill_call(self, tokens: torch.Tensor,
                      n_valid: torch.Tensor) -> None:
        super()._prefill_call(tokens, n_valid)
        self._count_draft_passes(1)
        self._draft_kv_rows_appended += int(n_valid.sum())
        self.draft_state = self.draft_lm.prefill_step(
            self.draft_params, self.draft_state, tokens, n_valid)

    def _set_slot_len(self, slot: int, n: int) -> None:
        super()._set_slot_len(slot, n)
        self.draft_state["len"][slot] = n

    def _copy_page(self, src: int, dst: int) -> None:
        super()._copy_page(src, dst)      # copy-on-write in both pools
        _pool_copy_page(self.draft_state["kv"], src, dst)

    # -- stats ----------------------------------------------------------------
    @property
    def acceptance_rate(self) -> float:
        """Accepted drafts / proposed drafts."""
        return self.accepted / max(self.proposed, 1)

    @property
    def committed_per_tick(self) -> float:
        return self.tokens_out / max(self.spec_ticks, 1)

    @property
    def committed_per_slot_tick(self) -> float:
        """Tokens committed per participating (slot, tick) pair."""
        return self.tokens_out / max(self.slot_ticks, 1)

    @property
    def draft_weight_read_bytes(self) -> int:
        return tree_bytes(self.draft_params)[0]

    @property
    def draft_kv_bytes_per_token(self) -> int:
        """Bytes of one appended draft KV row, at the draft's widths."""
        return self.draft_cfg.kv_bytes_per_token()

    @property
    def post_retune_acceptance(self) -> float:
        """Acceptance over the proposals made after the last retune (the
        lifetime rate when none fired)."""
        if not self.retune_events:
            return self.acceptance_rate
        last = self.retune_events[-1]
        return ((self.accepted - last["accepted"])
                / max(self.proposed - last["proposed"], 1))

    def metrics_snapshot(self) -> Dict[str, Any]:
        """The base snapshot plus the draft stream; the key set is
        ``obs.snapshot_keys(paged, speculative=True)``.
        ``draft_fused_analytic_bytes_per_pass`` is the lifetime mean
        (retunes move the per-pass figure)."""
        snap = super().metrics_snapshot()
        passes = self._draft_weight_passes
        snap.update({
            "k": self.k,
            "initial_k": self._initial_k,
            "draft_bits": self.draft_bits,
            "draft_kv_bits": self.draft_kv_bits,
            "spec_ticks": self.spec_ticks,
            "slot_ticks": self.slot_ticks,
            "proposed": self.proposed,
            "accepted": self.accepted,
            "acceptance_rate": self.acceptance_rate,
            "acceptance_ewma": self._ewma,
            "post_retune_acceptance": self.post_retune_acceptance,
            "committed_per_tick": self.committed_per_tick,
            "committed_per_slot_tick": self.committed_per_slot_tick,
            "retunes": len(self.retune_events),
            "draft_weight_passes": passes,
            "draft_weight_read_bytes_fused": self._draft_bytes_fused,
            "draft_weight_read_bytes_dense": self._draft_bytes_dense,
            "draft_fused_bytes_per_pass": self._draft_pass_bytes["fused"],
            "draft_fused_analytic_bytes_per_pass": (
                self._draft_bytes_analytic / passes if passes
                else self._draft_pass_bytes["analytic"]),
            "draft_kv_bytes_appended": (
                self._draft_kv_rows_appended * self._draft_kv_bytes_per_row),
        })
        return snap

    def run_until_drained(self, max_ticks: int = 10000) -> Dict[str, Any]:
        stats = super().run_until_drained(max_ticks)
        if self.adaptive:
            stats.update(adaptive=True,
                         retune_events=list(self.retune_events))
        return stats
