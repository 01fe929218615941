"""Batched decode serving with packed weights and a packed KV cache.

Port of the dense-KV and paged-KV modes of
``repro.serving.engine.ServeEngine``:

  * the residency planner (``core.occupancy.decode_residency``, H100 by
    default) sizes the slot count unless ``max_slots`` is given;
  * continuous batching: deque admission into free slots;
  * chunked prefill: admitted prompts stream through ``lm.prefill_step``
    ``prefill_chunk`` tokens at a time (chunk widths bucketed to powers
    of two), leaving one token per request for the first decode tick;
    the recurrent families (ssm, hybrid), whose state cannot take
    padding, feed their prompts one token a tick instead;
  * one ``decode_step`` over the whole slot array per tick, then greedy
    argmax or a sampled token per slot (``greedy=False``), and one
    device-to-host read of the tokens per tick. The tick is the
    pluggable stepper (``_generate``): ``serving.speculative.
    SpeculativeEngine`` replaces it with a draft/verify tick, through
    the hooks ``_seq_headroom``, ``_prefill_call``, ``_set_slot_len``,
    ``_copy_page`` and ``_trim_pages``.

``pack_weights=True`` (or a ``plan``) packs the weights at the planned
width (``uniform_plan`` + ``repack``); on the card the packing itself
runs through the ``pack`` kernel. ``params=`` serves given parameters
(parity runs pass the reference's, converted by ``interop``); otherwise
they are drawn with seed 0: by ``LM.init`` when the engine does not
pack, else leaf by leaf inside ``repack`` from ``LM.init_lazy``'s tree,
each slice of a stacked leaf (a layer, a bank's expert of a layer)
packed as soon as it is drawn, so the peak is the packed tree plus one
slice. Those draws follow ``LM.init``'s distribution, not its numbers.

``paged=True`` swaps the per-slot dense KV regions for a pool of
``kv_page_size``-row pages shared by all slots (``core.allocator.
KVPagePool``): per-request page tables, admission that reserves each
request's own worst case against the pool (so slots over-commit when
``kv_pool_pages`` is below slots x pages per sequence), refcounted
prefix pages shared between prompts that agree page for page, and
copy-on-write before an append into a shared page. The authoritative
page table lives on the device in ``state["table"]``; the host keeps a
shadow for bookkeeping and uploads only the rows a tick made dirty.
Decode attends through the table (``paged_attn``, the default);
``paged_attn=False`` takes the gather route, the parity oracle, which
runs on the CPU only.

Sampling draws with the Gumbel-max rule on the device, one (slots, V)
draw a tick from a ``torch.Generator`` seeded by the reference's key
structure: a per-engine nonce (``sample_seed`` pins it), folded with the
tick (and a salt for the speculative draft's stream); rows of the draw
are the slots, so slots draw independently. JAX's PRNG streams cannot
be reproduced, so sampled tokens match the reference in distribution
only.

A plan with ``kv_bits`` rewrites the config before the model is built,
as the reference does: uniform widths become the scalar ``kv_bits``,
mixed widths set ``kv_layer_bits`` (the width-segmented KV layout).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import secrets
import time
from typing import Any, Deque, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.allocator import KVPagePool, PoolExhausted
from repro_torch.core.compress import repack, uniform_plan
from repro_torch.core.occupancy import H100, decode_residency
from repro_torch.core.tensor_store import tree_bytes, tree_to, weight_pass_bytes
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import LM, Refused

BOS_TOKEN = 0          # fed when a request has no prompt
MAX_RESULTS = 65536    # finished outputs kept (FIFO)
SAMPLE_TAG = 0x5A3B1E  # the sampling streams' base key, as the reference's
_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(key: int, data: int) -> int:
    """A new 64-bit key from ``key`` and ``data`` (the role of
    ``jax.random.fold_in``)."""
    return _splitmix64(key ^ _splitmix64(data & _MASK64))


def sample_per_slot(gen: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """One categorical draw per row of (slots, V) logits, on their
    device: Gumbel-max, argmax(logits - log E) with E ~ Exp(1) drawn as
    one (slots, V) tensor from ``gen``. Each row takes its own stretch
    of the stream, so rows with equal logits draw independently. Shared
    by the plain engine's sampler and the speculative draft loop."""
    e = torch.empty(logits.shape, dtype=torch.float32, device=logits.device)
    e.exponential_(generator=gen)
    return (logits.float() - e.log()).argmax(dim=-1)


def _pool_copy_page(kv, src: int, dst: int) -> None:
    """Copy one physical page across every layer of a KV pool, K and V,
    in place: the stacked ``{"k", "v"}`` dict or the tuple of per-width
    segments (page ids are the same in every segment)."""
    for seg in (kv if isinstance(kv, tuple) else (kv,)):
        for pool in seg.values():
            pool[:, dst].copy_(pool[:, src])


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
    # speculative acceptance per request (0 / 0 on the plain engine)
    draft_proposed: int = 0
    draft_accepted: int = 0
    # paged-KV bookkeeping (all zero in dense mode)
    kv_len: int = 0          # host mirror of the device cache length
    n_pages: int = 0         # page-table entries currently held
    reserved_pages: int = 0  # promised-but-unallocated pool pages
    shared_pages: int = 0    # prefix pages retained from the registry
    pages_peak: int = 0      # max pages held: the actual-length footprint
    prefix_keys: List[bytes] = dataclasses.field(default_factory=list)
    # (table index, chain key) of shareable pages this request writes
    # itself: published only once prefill has filled them
    deferred_register: List[Any] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ServeEngine:
    cfg: ModelConfig
    max_seq_len: int = 256
    max_slots: Optional[int] = None
    greedy: bool = True
    pack_weights: bool = False     # pack params at the planned width
    prefill_chunk: int = 16        # prompt tokens ingested per prefill call
    plan: Optional[Any] = None     # a per-leaf CompressionPlan
    paged: bool = False            # paged KV: a shared page pool
    kv_page_size: int = 16         # rows per page (must divide max_seq_len)
    kv_pool_pages: Optional[int] = None  # None: slots x pages per sequence
    paged_attn: bool = True        # attend through the table (else gather)
    tracer: Optional[obs.Tracer] = None
    # every ``metrics_interval`` ticks a ``serve.metrics`` snapshot event,
    # mirrored into obs.REGISTRY gauges (0: at the drain's end only)
    metrics_interval: int = 0
    params: Optional[Dict] = None  # serve these instead of LM.init's
    device: Optional[Union[str, torch.device]] = None
    sample_seed: Optional[int] = None  # None: a fresh nonce per engine

    def __post_init__(self):
        if self.plan is not None and getattr(self.plan, "kv_bits", None):
            # per-layer KV widths rewrite the config before the model is
            # built: uniform widths collapse to the scalar knob, mixed
            # widths take the width-segmented layout
            widths = self.plan.kv_layer_widths(
                self.cfg.n_kv_layers, default=self.cfg.resolved_kv_bits)
            comp = self.cfg.compression
            if len(set(widths)) <= 1:
                comp = dataclasses.replace(
                    comp, kv_bits=widths[0] if widths else comp.kv_bits,
                    kv_layer_bits=None)
            else:
                comp = dataclasses.replace(comp, kv_bits=max(widths),
                                           kv_layer_bits=widths)
            self.cfg = dataclasses.replace(self.cfg, compression=comp)
        if self.tracer is None:
            self.tracer = obs.default_tracer()
        self.lm = LM(self.cfg, device=self.device, paged_attn=self.paged_attn)
        self.device = self.lm.device
        if self.paged and not self.paged_attn and self.device.type == "cuda":
            raise NotImplementedError(
                "paged_attn=False (the gather route) runs on the CPU only; "
                "on the card paged KV mode attends through the page table")
        packs = self.pack_weights or self.plan is not None
        if self.params is None:
            # a packing engine draws its own weights inside ``repack``,
            # each leaf a slice at a time into its packed words: the dense
            # tree never exists (granite-34b's is 68 GB of bf16)
            self.params = self.lm.init_lazy() if packs else self.lm.init()
        else:
            self.params = tree_to(self.params, self.device)
        self.weight_plan = None
        if packs:
            self.weight_plan = self.plan or uniform_plan(
                self.params, self.cfg.resolved_weight_bits)
            # in place, leaf by leaf: the engine owns this tree (its own
            # draws, or tree_to's copy of the caller's)
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
        self.pool: Optional[KVPagePool] = None
        if self.paged:
            if not self.lm.supports_rollback:
                raise Refused(
                    f"family {self.cfg.family!r} keeps recurrent O(1) "
                    "decode state; there are no KV rows to page: serve it "
                    "in dense KV mode (paged KV mode refused)")
            if self.max_seq_len % self.kv_page_size:
                raise Refused(
                    f"kv_page_size {self.kv_page_size} must divide "
                    f"max_seq_len {self.max_seq_len} (paged KV mode)")
            self._max_pages = self.max_seq_len // self.kv_page_size
            if self.kv_pool_pages is None:
                self.kv_pool_pages = self.n_slots * self._max_pages
            self.pool = KVPagePool(self.kv_pool_pages, self.kv_page_size)
            self.pool.on_event = self.tracer.event
            # the host shadow of state["table"]: bookkeeping marks rows
            # dirty, _push_tables uploads only those before a call
            self._table = np.zeros((self.n_slots, self._max_pages), np.int32)
            self._dirty_rows: set = set()
            self.state = self.lm.init_paged_decode_state(
                self.n_slots, self.max_seq_len, self.kv_page_size,
                self.kv_pool_pages)
        else:
            self.state = self.lm.init_decode_state(self.n_slots,
                                                   self.max_seq_len)
        if self.cfg.family == "encdec":
            self.state["clen"].fill_(self.cfg.encoder_seq)
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
        self._cow_copies = 0
        self._table_uploads = 0
        self._table_upload_bytes = 0
        self._table_rows_uploaded = 0
        self._kv_pages_read = 0
        self._kv_pages_read_dense_equiv = 0
        # sampling keys: the base folds in a per-engine nonce (without it
        # a restarted engine replays its stream), each tick folds in the
        # tick counter; ``sample_seed`` pins the nonce, masked to 31 bits
        # as the reference masks it
        self._sample_nonce = (int(self.sample_seed) & 0x7FFFFFFF
                              if self.sample_seed is not None
                              else secrets.randbits(31))
        self._sample_base = fold_in(SAMPLE_TAG, self._sample_nonce)
        self._sample_gen = torch.Generator(device=self.device)

    # -- client API -----------------------------------------------------------
    @property
    def _seq_headroom(self) -> int:
        """Extra KV rows a tick may append past the committed length (0
        here; k for the speculative engine)."""
        return 0

    def submit(self, prompt: List[int], max_new_tokens: int = 16) -> int:
        # prompt + all-but-the-last generated token (+ the speculation
        # headroom) must fit the cache; past max_seq_len the append would
        # clamp onto the last row. Recurrent state is O(1) in length and
        # the hybrid's windowed cache wraps, so only row caches overflow
        need = (max(len(prompt), 1) + max_new_tokens - 1
                + self._seq_headroom)
        if self.lm.supports_rollback and need > self.max_seq_len:
            mode = ("paged KV mode: page table holds "
                    f"{self._max_pages} pages of {self.kv_page_size}"
                    if self.paged else "dense KV mode")
            raise Refused(
                f"request needs {need} KV rows (prompt {len(prompt)} + "
                f"{max_new_tokens} new + headroom {self._seq_headroom}) "
                f"but max_seq_len is {self.max_seq_len} [{mode}]")
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
    def pool_utilization(self) -> float:
        """Pages used / pool pages (0.0 in dense mode)."""
        return self.pool.utilization if self.pool is not None else 0.0

    @property
    def prefix_hit_rate(self) -> float:
        """Prefix-page registry hit rate across admissions (0.0 dense)."""
        return self.pool.prefix_hit_rate if self.pool is not None else 0.0

    @property
    def weight_read_bytes(self) -> int:
        """Bytes one full weight pass streams (packed where packed)."""
        return tree_bytes(self.params)[0]

    # -- scheduler ------------------------------------------------------------
    def _set_slot_len(self, slot: int, n: int) -> None:
        """Set one slot's device cache length (in place)."""
        self.state["len"][slot] = n

    def _reset_slot(self, slot: int) -> None:
        """Recycle a slot: zero its cache length (rows past len are dead).
        As in the reference, a recurrent family's conv/ssm/h state is not
        cleared: the next request starts from its predecessor's."""
        self._set_slot_len(slot, 0)

    def _admit(self) -> None:
        admitted = False
        while self._queue and self._free:
            if self.paged and not self._try_reserve(self._queue[0]):
                break   # pool-aware headroom: the head waits for pages
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
            pending = list(req.prompt) or [BOS_TOKEN]
            if self.paged:
                pending = self._attach_pages(req, pending)
            self._pending_prefill[req.rid] = pending
        # chunked ingestion needs padding rows to be dead rows; the
        # recurrent families fold every token they are fed, so their
        # prompts go through the ticks one token at a time (_generate)
        if admitted and self.lm.supports_rollback:
            self._ingest_prompts()

    # -- paged-KV page management ---------------------------------------------
    def _try_reserve(self, req: Request) -> bool:
        """Admission against the pool: reserve the pages this request's
        own worst case needs (prompt + max_new - 1 + speculation headroom
        rows), less the prompt-prefix pages already in the registry."""
        pending = list(req.prompt) or [BOS_TOKEN]
        need = len(pending) + req.max_new_tokens - 1 + self._seq_headroom
        pages_needed = -(-need // self.kv_page_size)
        # full pages strictly below the held-back last prompt token are
        # shareable; probe the chain left to right (a miss ends it)
        shareable = (len(pending) - 1) // self.kv_page_size
        keys: List[bytes] = []
        parent: Optional[bytes] = None
        for i in range(shareable):
            toks = pending[i * self.kv_page_size:
                           (i + 1) * self.kv_page_size]
            parent = KVPagePool.chain_key(parent, toks)
            keys.append(parent)
        matched = 0
        for key in keys:
            if self.pool.lookup(key) is None:
                break
            matched += 1
        reservation = pages_needed - matched
        if not self.pool.can_reserve(reservation):
            return False
        self.pool.reserve(reservation)
        req.reserved_pages = reservation
        req.shared_pages = matched
        req.prefix_keys = keys
        return True

    def _attach_pages(self, req: Request, pending: List[int]) -> List[int]:
        """Wire the admitted request's page table: retain the matched
        prefix pages (their rows are resident, so those prompt tokens
        skip prefill), then allocate the other shareable pages, which
        publish only once prefill has written them
        (``_flush_registrations``). Later pages allocate as the sequence
        grows (``_ensure_rows``). Returns the tokens left to prefill."""
        slot, pool = req.slot, self.pool
        for i, key in enumerate(req.prefix_keys):
            if i < req.shared_pages:
                page = pool.lookup(key)
                pool.prefix_queries -= 1   # a re-probe, not a new query
                pool.prefix_hits -= 1
                pool.retain(page)
            else:
                page = pool.alloc(reserved=True)
                req.reserved_pages -= 1
                req.deferred_register.append((i, key))
            self._table[slot, i] = page
            self._dirty_rows.add(slot)
            req.n_pages += 1
        req.pages_peak = max(req.pages_peak, req.n_pages)
        skip = req.shared_pages * self.kv_page_size
        if skip:
            req.kv_len = skip
            self._set_slot_len(slot, skip)
        return pending[skip:]

    def _alloc_page(self, req: Request) -> int:
        """One page for ``req``: its reservation first, the free bucket
        as the (copy-on-write) fallback."""
        if req.reserved_pages > 0:
            page = self.pool.alloc(reserved=True)
            req.reserved_pages -= 1
            return page
        try:
            return self.pool.alloc()
        except PoolExhausted as e:
            raise PoolExhausted(
                f"{e} [paged KV mode: request {req.rid} needs a page "
                "beyond its admission reservation]") from e

    def _ensure_rows(self, req: Request, rows: int) -> None:
        """Grow the request's page table to cover ``rows`` cache rows
        before a call appends them (real rows must land on owned pages;
        writes through unallocated entries land on the scrap page)."""
        needed = min(-(-rows // self.kv_page_size), self._max_pages)
        self._ensure_tail_private(req)
        while req.n_pages < needed:
            page = self._alloc_page(req)
            self._table[req.slot, req.n_pages] = page
            self._dirty_rows.add(req.slot)
            req.n_pages += 1
        req.pages_peak = max(req.pages_peak, req.n_pages)

    def _ensure_tail_private(self, req: Request) -> None:
        """Copy-on-write: if the page that takes this request's next
        append is shared (refcount > 1), give the request a private copy
        first. Pages of the registered prefix are exempt: the request
        that registered one fills it during prefill, which is what its
        sharers expect."""
        idx = req.kv_len // self.kv_page_size
        if idx >= req.n_pages or idx < len(req.prefix_keys):
            return
        page = int(self._table[req.slot, idx])
        if self.pool.refcount(page) <= 1:
            return
        fresh = self._alloc_page(req)
        with self.tracer.span("serve.cow", rid=req.rid, src=page, dst=fresh):
            self._copy_page(page, fresh)
        self._cow_copies += 1
        self._table[req.slot, idx] = fresh
        self._dirty_rows.add(req.slot)
        self.pool.free(page)               # drop our share of the original
        if idx < req.shared_pages:
            req.shared_pages = idx

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one physical page across every layer, K and V, on the
        device."""
        _pool_copy_page(self.state["kv"], src, dst)

    def _trim_pages(self, req: Request) -> None:
        """Free the pages past the committed length (speculation rolled
        the cache back). A page this request held alone goes back into
        its reservation, so pool use tracks committed rows and the
        admission guarantee holds."""
        keep = max(-(-req.kv_len // self.kv_page_size), 1)
        while req.n_pages > keep:
            req.n_pages -= 1
            page = int(self._table[req.slot, req.n_pages])
            self._table[req.slot, req.n_pages] = 0
            self._dirty_rows.add(req.slot)
            sole = self.pool.refcount(page) == 1
            self.pool.free(page)
            if sole:
                self.pool.reserve(1)
                req.reserved_pages += 1

    def _flush_registrations(self, req: Request) -> None:
        """Publish shareable pages whose rows prefill has now written
        (``kv_len`` crossed their end). A writer of the same prefix in
        the same batch may have registered first; then ours stay
        private."""
        while req.deferred_register:
            i, key = req.deferred_register[0]
            if (i + 1) * self.kv_page_size > req.kv_len:
                return
            req.deferred_register.pop(0)
            if not self.pool.is_registered(key):
                self.pool.register(key, int(self._table[req.slot, i]))

    def _release_pages(self, req: Request) -> None:
        """At finish: drop every held page (a shared page loses one
        holder; a last holder returns it, and its registry entry, to the
        pool) and any unused reservation."""
        for i in range(req.n_pages):
            self.pool.free(int(self._table[req.slot, i]))
        self._table[req.slot, :] = 0
        if req.n_pages:
            self._dirty_rows.add(req.slot)
        req.n_pages = 0
        req.deferred_register.clear()      # unpublished keys die with us
        self.pool.release(req.reserved_pages)
        req.reserved_pages = 0

    def _table_delta(self):
        """(idx, rows) int32 arrays of the dirty slots, padded to a
        power-of-two count by repeating the first index (the same row
        with the same data), as the reference pads its upload."""
        idx = sorted(self._dirty_rows)
        n = 1
        while n < len(idx):
            n *= 2
        idx = np.asarray(idx + [idx[0]] * (n - len(idx)), np.int32)
        return idx, self._table[idx]

    def _push_tables(self) -> None:
        """Bring the device table up to date before a call: nothing on a
        clean tick, the dirty rows otherwise, or one full upload when at
        least half the slots are dirty."""
        if not self._dirty_rows:
            return
        rows_dirty = len(self._dirty_rows)
        if 2 * rows_dirty >= self.n_slots:
            idx, rows = None, None
            nbytes = self._table.nbytes
        else:
            idx, rows = self._table_delta()
            nbytes = int(idx.nbytes + rows.nbytes)
        with self.tracer.span("serve.h2d_table", bytes=nbytes,
                              rows=rows_dirty,
                              mode="full" if idx is None else "delta"):
            self._apply_table_update(idx, rows)
        self._dirty_rows.clear()
        self._table_uploads += 1
        self._table_upload_bytes += nbytes
        self._table_rows_uploaded += rows_dirty
        obs.REGISTRY.counter(
            "serve_table_rows_uploaded_total",
            "Dirty page-table rows uploaded to the device table.",
        ).inc(rows_dirty)

    def _apply_table_update(self, idx: Optional[np.ndarray],
                            rows: Optional[np.ndarray]) -> None:
        """One upload to ``state["table"]``, in place: every row when
        ``idx`` is None, else ``rows`` at ``idx`` (one ``index_copy_``)."""
        table = self.state["table"]
        if idx is None:
            table.copy_(torch.from_numpy(self._table))
        else:
            table.index_copy_(0, torch.from_numpy(idx).to(self.device).long(),
                              torch.from_numpy(rows).to(self.device))

    def _count_pages_read(self, len0s: Sequence[int],
                          positions: int) -> Optional[int]:
        """Pages the fused paged attention reads in a call that walks
        ``positions`` append steps: at step i a resident slot with
        ``len0`` committed rows reads ceil((len0 + i) / page) pages (one
        logical page spans every layer's K and V rows). Dead slots read
        nothing. None when the call does not attend through the table
        (dense mode, or the gather route); also accrues the
        dense-equivalent figure, slots x max_pages per step."""
        if not (self.paged and self.paged_attn):
            return None
        pg = self.kv_page_size
        pages = 0
        for len0 in len0s:
            for i in range(1, positions + 1):
                pages += -(-min(len0 + i, self.max_seq_len) // pg)
        self._kv_pages_read += pages
        self._kv_pages_read_dense_equiv += (
            positions * self.n_slots * self._max_pages)
        obs.REGISTRY.counter(
            "kv_pages_read_total",
            "KV pool pages the fused paged-attention path reads.",
        ).inc(pages)
        return pages

    def _paged_attn_span(self, pages: Optional[int], positions: int):
        """Span around a call that attends through the table (none
        otherwise)."""
        if pages is None:
            return contextlib.nullcontext()
        return self.tracer.span(
            "serve.paged_attn", pages=pages, positions=positions,
            dense_equiv_pages=positions * self.n_slots * self._max_pages)

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
            len0s = ([r.kv_len for r in self._active.values()]
                     if self.paged else ())
            for rid, toks in pending.items():
                req = self._active[rid]
                take = min(chunk, len(toks) - 1)
                tokens[req.slot, :take] = toks[:take]
                n_valid[req.slot] = take
                del toks[:take]
                if self.paged:
                    self._ensure_rows(req, req.kv_len + take)
                    req.kv_len += take
                    self._flush_registrations(req)
            if self.paged:
                self._push_tables()
            rows = int(n_valid.sum())
            self._kv_rows_appended += rows
            self._kv_rows_committed += rows
            pages = self._count_pages_read(len0s, chunk)
            with self.tracer.span("serve.prefill", chunk=chunk, rows=rows,
                                  requests=len(pending)), \
                    self._paged_attn_span(pages, chunk):
                self._prefill_call(torch.from_numpy(tokens).to(self.device),
                                   torch.from_numpy(n_valid).to(self.device))

    def _prefill_call(self, tokens: torch.Tensor,
                      n_valid: torch.Tensor) -> None:
        """One chunked KV append over the slot array (the speculative
        engine mirrors it into its draft cache)."""
        self._prefill_calls += 1
        self._weight_passes += 1
        self.state = self.lm.prefill_step(self.params, self.state, tokens,
                                          n_valid)

    def _tick_key(self, salt: int = 0) -> int:
        """The tick's sampling key: the engine's base folded with the
        tick counter, and with ``salt`` for another stream (the
        speculative draft's)."""
        key = fold_in(self._sample_base, self.ticks)
        return fold_in(key, salt) if salt else key

    def _generator(self, key: int) -> torch.Generator:
        """The engine's generator on its device, seeded with ``key``."""
        return self._sample_gen.manual_seed(key)

    def _sample_tokens(self, logits: torch.Tensor) -> torch.Tensor:
        """One token per slot of (slots, V) logits, from the tick's key."""
        return sample_per_slot(self._generator(self._tick_key()), logits)

    def _generate(self) -> Dict[int, List[int]]:
        """One decode tick: the token committed per request id."""
        tokens = self._last_tokens.copy()
        for req in self._active.values():
            pend = self._pending_prefill.get(req.rid)
            if pend:
                tokens[req.slot, 0] = pend.pop(0)
        if self.paged:
            # every resident slot appends one row this tick
            for req in self._active.values():
                self._ensure_rows(req, req.kv_len + 1)
            self._push_tables()
        self._decode_calls += 1
        self._weight_passes += 1
        rows = len(self._active)
        self._kv_rows_appended += rows
        self._kv_rows_committed += rows
        pages = self._count_pages_read(
            [r.kv_len for r in self._active.values()], 1)
        with self.tracer.span("serve.decode", requests=rows), \
                self._paged_attn_span(pages, 1):
            logits, self.state = self.lm.decode_step(
                self.params, self.state,
                torch.from_numpy(tokens).to(self.device))
            nxt = (logits[:, 0, :].argmax(dim=-1) if self.greedy
                   else self._sample_tokens(logits[:, 0, :])).cpu().numpy()
        if self.paged:
            for req in self._active.values():
                req.kv_len = min(req.kv_len + 1, self.max_seq_len)
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
                if self.paged:
                    self._release_pages(req)  # pages to the pool first,
                self._free.append(req.slot)   # then the slot
                self._pending_prefill.pop(rid, None)
            self._finished_total += len(finished)
            while len(self._results) > MAX_RESULTS:
                self._results.pop(next(iter(self._results)))
            self._admit()
            self.ticks += 1
            self.tokens_out += emitted
            sp["emitted"] = emitted
            sp["finished"] = len(finished)
        if self.metrics_interval and self.ticks % self.metrics_interval == 0:
            self._emit_metrics()
        return emitted

    # -- observability --------------------------------------------------------
    def metrics_snapshot(self) -> Dict[str, Any]:
        """Point-in-time stats from host-side counters; the key set is
        ``obs.snapshot_keys(paged)``, the reference's."""
        snap: Dict[str, Any] = {
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
        if self.pool is not None:
            ev = self.pool.events
            snap.update({
                "kv_page_size": self.kv_page_size,
                "kv_pool_pages": self.kv_pool_pages,
                "pool_utilization": self.pool.utilization,
                "pool_peak_utilization": self.pool.peak_utilization,
                "pool_pages_used": self.pool.used,
                "pool_pages_reserved": self.pool.reserved,
                "pool_pages_free": self.pool.free_pages,
                "prefix_hit_rate": self.pool.prefix_hit_rate,
                "prefix_hits": self.pool.prefix_hits,
                "prefix_queries": self.pool.prefix_queries,
                "pool_alloc_total": ev["alloc"],
                "pool_free_total": ev["free"],
                "pool_retain_total": ev["retain"],
                "pool_evict_total": ev["evict"],
                "pool_reserve_total": ev["reserve"],
                "pool_release_total": ev["release"],
                "cow_copies": self._cow_copies,
                "table_uploads": self._table_uploads,
                "table_upload_bytes": self._table_upload_bytes,
                "table_rows_uploaded": self._table_rows_uploaded,
                "paged_attn": bool(self.paged_attn),
                "kv_pages_read": self._kv_pages_read,
                "kv_pages_read_dense_equiv":
                    self._kv_pages_read_dense_equiv,
                # a logical page is page_size rows across every layer's
                # K and V, at kv_bytes_appended's per-row constant
                "kv_pages_read_bytes":
                    self._kv_pages_read * self.kv_page_size
                    * self._kv_bytes_per_row,
            })
        return snap

    def _emit_metrics(self) -> Dict[str, Any]:
        """A snapshot as a ``serve.metrics`` event and as REGISTRY gauges
        (``serve_<key>``, the last engine's value)."""
        snap = self.metrics_snapshot()
        self.tracer.event("serve.metrics", **snap)
        for key, val in snap.items():
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            obs.REGISTRY.gauge(f"serve_{key}",
                               f"ServeEngine {key} (live mirror)."
                               ).set(float(val))
        return snap

    def run_until_drained(self, max_ticks: int = 10000) -> Dict[str, Any]:
        t0 = time.perf_counter()
        while (self._queue or self._active) and self.ticks < max_ticks:
            self.step()
        dt = time.perf_counter() - t0
        stats: Dict[str, Any] = self._emit_metrics()
        stats["wall_s"] = dt
        return stats
