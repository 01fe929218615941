"""Model assembly for the dense and MoE families: init, decode state,
decode steps.

Port of the serving surface of ``repro.models.lm.LM``:

  * ``init(gen)``                          -> params (stacked (L, ...) leaves)
  * ``init_decode_state(batch, seq_len)``  -> zeroed dense per-slot KV state
  * ``init_paged_decode_state(batch, seq_len, page_size, n_pages)``
                                           -> zeroed page pool + page table
  * ``decode_step(params, state, tokens)`` -> (logits (B, 1, V), state)
  * ``verify_step(params, state, tokens)`` -> (logits (B, T, V), state)
  * ``prefill_step(params, state, tokens, n_valid)`` -> state
  * ``rollback_decode_state(state, lengths)`` -> state
  * ``logits_fn(params, x)``

The reference's ``lax.scan`` over the stacked layers becomes a Python
loop over layer slices; a slice of a contiguous stacked payload is
contiguous, so the kernels read it in place. The per-layer views are
built once per parameter tree (``layer_params``). The KV cache is
updated in place (the returned state shares it with the one passed in);
``len`` is a new tensor each step. The MoE family runs ``moe_apply`` in
place of ``mlp_apply``; its stacked (L, E, K, N) expert banks slice to
per-layer 3-D banks. Other families come with ROADMAP A12.

Per-layer KV widths (``compression.kv_layer_bits``) take the reference's
width-segmented layout: ``kv`` is a tuple of ``{"k", "v"}`` buffers, one
per contiguous run of equal-width layers (``cfg.kv_segments()``), each
packed at its own width, dense or as pools over one page axis and one
table. Each layer appends and attends at its own width. A uniform
config keeps the single stacked dict.

A paged state (one with a ``table``) takes the fused route by default
(``paged_attn``): each layer appends straight to its pool and attends
through the table. ``paged_attn=False`` takes the gather route (gather
each layer's pages into the dense view, run the dense program, scatter
the new row back), the parity oracle, on CPU tensors only.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core import bitpack
from repro_torch.core.tensor_store import is_packed, tree_map_with_path
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def layer_slice(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a stacked (L, ...) parameter tree."""
    return tree_map_with_path(
        lambda _, leaf: leaf.layer(i) if is_packed(leaf) else leaf[i], tree)


def _cpu_only(t: torch.Tensor, name: str) -> None:
    if t.is_cuda:
        raise NotImplementedError(
            f"{name}: the gather route runs on the CPU only; on the card "
            "paged decode takes the fused route (paged_attn=True)")


def gather_kv_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The per-sequence cache view of one layer's pool (P+1, page, Hkv,
    W) through ``table`` (B, max_pages): (B, max_pages*page, Hkv, W).
    Rows gathered through scrap entries lie at or past each sequence's
    length, where attention masks them. The gather route's materialized
    copy, on CPU tensors only."""
    _cpu_only(pool, "gather_kv_pages")
    kops.record_dispatch("gather_kv_pages", "materialized",
                         shape=tuple(pool.shape))
    return kref.gather_pages_ref(pool, table)


def scatter_kv_row(pool: torch.Tensor, view: torch.Tensor,
                   table: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Write the row the dense program appended to ``view`` at
    ``lens[b]`` back to its physical page of ``pool``, in place; lengths
    past the view clamp to its last row (the scrap page for an idle
    slot). CPU tensors only."""
    _cpu_only(pool, "scatter_kv_row")
    pos = lens.long().clamp(0, view.shape[1] - 1)
    kref.scatter_pool_rows(pool, view[torch.arange(view.shape[0]), pos],
                           kref.pool_row_index(pool.shape[1], table, pos))
    return pool


@dataclasses.dataclass
class LM:
    cfg: ModelConfig
    device: Optional[Union[str, torch.device]] = None
    # paged states: attend through the table (True) or take the gather
    # route (False, the CPU parity oracle); no effect on dense states
    paged_attn: bool = True
    # (params, per-layer views) of the last parameter tree decoded from
    _views: Optional[Tuple[Dict, List[Dict]]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet (ROADMAP A12)")

    # ------------------------------------------------------------------ init
    def init(self, gen: Optional[torch.Generator] = None) -> Dict:
        """Random parameters from ``gen`` (a generator on this LM's
        device; seed 0 when none is given). The reference draws from
        JAX's PRNG, which torch cannot reproduce: parity runs pass the
        reference's parameters in (``interop.params_from_numpy``)."""
        cfg = self.cfg
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
        dt = cfg.compute_dtype
        params: Dict[str, Any] = {
            "embed": L.init_dense(gen, (cfg.vocab_size, cfg.d_model),
                                  scale=0.02, dtype=dt),
            "final_norm": torch.zeros((cfg.d_model,), dtype=dt,
                                      device=self.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.init_dense(
                gen, (cfg.d_model, cfg.vocab_size), dtype=dt)
        blocks = {"attn": B.init_attention(gen, cfg, cfg.n_layers)}
        if cfg.family == "moe":
            blocks["moe"] = B.init_moe(gen, cfg, cfg.n_layers)
        else:
            blocks["mlp"] = B.init_mlp(gen, cfg, cfg.n_layers)
        params["blocks"] = blocks
        return params

    def logits_fn(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = L.rms_norm(x, params["final_norm"])
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        return L.unembed(x, head, cfg.tie_embeddings)

    # --------------------------------------------------------------- decode
    def _kv_segment_layout(self) -> Optional[Tuple[Tuple[int, int, int], ...]]:
        """``cfg.kv_segments()`` when the config carries per-layer KV
        widths (checked as the reference checks them), else None: the
        uniform single-buffer layout."""
        cfg = self.cfg
        klb = cfg.compression.kv_layer_bits
        if klb is None:
            return None
        if len(klb) != cfg.n_kv_layers:
            raise ValueError(f"kv_layer_bits has {len(klb)} entries for "
                             f"{cfg.n_kv_layers} KV layers")
        if not cfg.compression.kv_bits:
            raise ValueError(
                "kv_layer_bits requires kv_bits (set it to the max "
                "per-layer width; None means a dense, unpacked cache)")
        if max(klb) != cfg.compression.kv_bits:
            raise ValueError(f"kv_bits ({cfg.compression.kv_bits}) must "
                             f"equal max(kv_layer_bits) = {max(klb)}")
        return cfg.kv_segments()

    def _kv_buffers(self, rows: Tuple[int, ...]):
        """Zeroed K and V buffers of (layers, *rows, Hkv, W): int32 words
        when the KV packs, else (..., Hkv, D) in the compute dtype. One
        stacked dict, or a tuple of them per width segment."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim

        def kv(layers: int, bits: Optional[int]) -> Dict:
            shape = (layers, *rows, cfg.n_kv_heads,
                     bitpack.packed_group_words(hd, bits) if bits else hd)
            dt = torch.int32 if bits else cfg.compute_dtype
            return {name: torch.zeros(shape, dtype=dt, device=self.device)
                    for name in ("k", "v")}

        segs = self._kv_segment_layout()
        if segs is None:
            return kv(cfg.n_layers, cfg.compression.kv_bits)
        return tuple(kv(hi - lo, bits) for lo, hi, bits in segs)

    def _kv_layers(self, kv) -> List[Tuple[Dict, int, Optional[int]]]:
        """Per layer: (its segment's {k, v} buffers, its index there, its
        KV width) for the state's ``kv`` (a stacked dict or a tuple of
        width segments)."""
        if isinstance(kv, tuple):
            return [(seg, i - lo, bits) for (lo, hi, bits), seg
                    in zip(self.cfg.kv_segments(), kv)
                    for i in range(lo, hi)]
        return [(kv, i, self.cfg.compression.kv_bits)
                for i in range(self.cfg.n_layers)]

    def init_decode_state(self, batch_size: int, seq_len: int) -> Dict:
        """Zeroed decode state: ``len`` (B,) int32 and the cache ``kv``
        {k, v} of (L, B, S, Hkv, W), or a tuple of such dicts per width
        segment."""
        return {
            "len": torch.zeros((batch_size,), dtype=torch.int32,
                               device=self.device),
            "kv": self._kv_buffers((batch_size, seq_len)),
        }

    def init_paged_decode_state(self, batch_size: int, seq_len: int,
                                page_size: int, n_pages: int) -> Dict:
        """Zeroed paged decode state: ``len`` (B,) int32, the page
        ``table`` (B, seq_len // page_size) int32, and the pools ``kv``
        {k, v} of (L, n_pages + 1, page_size, Hkv, W) (a tuple of them
        per width segment, over the same page axis); page 0 is the scrap
        page, the target of every unallocated table entry. ``page_size``
        must divide ``seq_len``, so the pages a table row names span the
        dense cache's S rows."""
        if seq_len % page_size:
            raise ValueError(
                f"kv_page_size {page_size} must divide max_seq_len "
                f"{seq_len} so gathered pages keep the dense cache shape")
        return {
            "len": torch.zeros((batch_size,), dtype=torch.int32,
                               device=self.device),
            "table": torch.zeros((batch_size, seq_len // page_size),
                                 dtype=torch.int32, device=self.device),
            "kv": self._kv_buffers((n_pages + 1, page_size)),
        }

    def layer_params(self, params: Dict) -> List[Dict]:
        """Layer ``i``'s parameters for every layer, built once per
        parameter tree (the tree is read-only while it serves): stacked
        leaves sliced (a stacked (L, E, K, N) expert bank gives a 3-D
        bank per layer), and packed norm scales — rank 1 once sliced,
        with no kernel path — decoded here once instead of on every
        step."""
        if self._views is None or self._views[0] is not params:
            def decode_norms(_, leaf):
                if is_packed(leaf) and len(leaf.logical_shape) == 1:
                    return L.unpack_maybe(leaf)
                return leaf
            views = [tree_map_with_path(decode_norms,
                                        layer_slice(params["blocks"], i))
                     for i in range(self.cfg.n_layers)]
            self._views = (params, views)
        return self._views[1]

    def _hidden(self, params, state: Dict,
                tokens: torch.Tensor) -> torch.Tensor:
        """The decode body: embed, every layer (appending this token's KV
        row at ``len``), the final hidden state (B, 1, d). A paged state
        takes the fused route or, without ``paged_attn``, the gather
        route."""
        cfg = self.cfg
        x = L.embed(tokens, params["embed"]).to(cfg.compute_dtype)
        lens = state["len"]
        positions = lens[:, None]
        table = state.get("table")
        for lp, (seg, j, bits) in zip(self.layer_params(params),
                                      self._kv_layers(state["kv"])):
            layer_kv = {"k": seg["k"][j], "v": seg["v"][j]}
            if table is None:
                x, _ = B.attention_decode(lp["attn"], x, cfg,
                                          dict(layer_kv, len=lens), positions,
                                          kv_bits=bits)
            elif self.paged_attn:
                x, _ = B.attention_decode_paged(lp["attn"], x, cfg, layer_kv,
                                                table, lens, positions,
                                                kv_bits=bits)
            else:
                st = {"k": gather_kv_pages(layer_kv["k"], table),
                      "v": gather_kv_pages(layer_kv["v"], table), "len": lens}
                x, st = B.attention_decode(lp["attn"], x, cfg, st, positions,
                                           kv_bits=bits)
                for name in ("k", "v"):
                    scatter_kv_row(layer_kv[name], st[name], table, lens)
            if cfg.family == "moe":
                x = B.moe_apply(lp["moe"], x, cfg)
            else:
                x = B.mlp_apply(lp["mlp"], x, cfg)
        return x

    def decode_step(self, params, state: Dict,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """tokens (B, 1) -> (logits (B, 1, V), state with len + 1)."""
        x = self._hidden(params, state, tokens)
        logits = self.logits_fn(params, x)
        return logits, dict(state, len=state["len"] + 1)

    def verify_step(self, params, state: Dict,
                    tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """tokens (B, T) -> (logits (B, T, V), state with len + T): T
        single-token decode steps, the same program as T ``decode_step``
        calls."""
        per_pos = []
        for t in range(tokens.shape[1]):
            logits, state = self.decode_step(params, state, tokens[:, t:t + 1])
            per_pos.append(logits[:, 0])
        return torch.stack(per_pos, dim=1), state

    def prefill_step(self, params, state: Dict, tokens: torch.Tensor,
                     n_valid: torch.Tensor) -> Dict:
        """Ingest a prompt chunk (B, C) with ``n_valid`` (B,) real tokens
        per sequence through the decode append path, then set
        ``len = len_before + n_valid``: padding rows land past the valid
        length, where they are masked and later overwritten. The
        per-position logits are not computed (the reference's jitted
        prefill drops them as dead code)."""
        len0 = state["len"]
        for t in range(tokens.shape[1]):
            self._hidden(params, state, tokens[:, t:t + 1])
            state = dict(state, len=state["len"] + 1)
        return dict(state, len=len0 + n_valid.to(torch.int32))

    def rollback_decode_state(self, state: Dict,
                              lengths: torch.Tensor) -> Dict:
        """Roll the cache back to ``lengths`` valid rows: rows past
        ``len`` are dead, so this is a length reset."""
        return dict(state, len=torch.as_tensor(
            lengths, dtype=torch.int32, device=self.device))
