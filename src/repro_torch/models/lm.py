"""Model assembly for every family: init, the forward over a sequence
(prefill and the loss), decode state and decode steps.

Port of ``repro.models.lm.LM``:

  * ``init(gen)``                          -> params (stacked (L, ...) leaves)
  * ``loss(params, batch, s_chunk)``       -> scalar LM loss (differentiable)
  * ``prefill(params, batch)``             -> (last-position logits, {})
  * ``input_specs(shape)``                 -> (shape, dtype) of every input
  * ``init_decode_state(batch, seq_len)``  -> zeroed per-slot decode state
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
built once per parameter tree (``layer_params``), and the forward over
a sequence and the decode body walk the same views. The decode state is
updated in place (the returned state shares its caches and recurrent
state with the one passed in); ``len`` is a new tensor each step.

``prefill`` and ``loss`` take the reference's batch dicts: ``tokens``
(B, T), ``labels`` (B, T) for the loss, the vlm's ``patch_embeds`` (B,
num_image_tokens, d) f32 (the image prefix, put before the tokens) and
encdec's ``frames`` (B, encoder_seq, d) f32 (the encoder's input). As in
the reference, the vlm's prefix attends causally (``attention_apply``
does not pass it on), and the loss sums ``T // s_chunk`` whole chunks
and divides by B T. ``prefill`` returns no decode state: serving ingests
prompts through ``prefill_step``.

Families: dense and vlm (attention and MLP), moe (``moe_apply`` in place
of ``mlp_apply``; its stacked (L, E, K, N) expert banks slice to
per-layer 3-D banks), encdec (decoder self-attention, cross-attention
over the encoder's output at prefill, over the cross cache ``cross``
{ck, cv} for ``clen`` rows when decoding, MLP), ssm (Mamba-1 blocks over
``conv`` and ``ssm`` state) and hybrid (groups of ``pattern_rec`` RG-LRU
layers and one local-attention layer, each followed by an MLP, then a
tail of RG-LRU layers; the attention cache is a ring of
``min(attn_window, seq_len)`` rows). The recurrent families cannot roll
their state back (``supports_rollback``), so they neither page nor
speculate, and the engine feeds their prompts one token a tick.

Per-layer KV widths (``compression.kv_layer_bits``, dense, vlm and moe)
take the reference's width-segmented layout: ``kv`` is a tuple of
``{"k", "v"}`` buffers, one per contiguous run of equal-width layers
(``cfg.kv_segments()``), each packed at its own width, dense or as pools
over one page axis and one table. Each layer appends and attends at its
own width. A uniform config keeps the single stacked dict.

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
from repro_torch.core.tensor_store import (is_draw, is_packed, is_st,
                                           tree_leaves, tree_map_with_path)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, ShapeConfig


class Refused(ValueError):
    """A mode or setting the model or its engine does not serve (paged KV
    or rollback for recurrent state, per-layer KV widths it cannot lay
    out, a speculative setting out of range): the caller's to change,
    unlike a fault inside."""


def layer_slice(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a stacked (L, ...) parameter tree; an ``STWeight``'s
    master slice is a view, so a layer's gradient reaches the stack."""
    return tree_map_with_path(
        lambda _, leaf: (leaf.layer(i) if is_packed(leaf) or is_st(leaf)
                         else leaf[i]), tree)


def _trainable(params: Dict) -> bool:
    """True when the tree carries ``STWeight``s or tensors that require
    grad: a training tree, whose views hold autograd graph and whose
    masters change in place between steps."""
    return any(is_st(leaf) or getattr(leaf, "requires_grad", False)
               for leaf in tree_leaves(params))


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
    # (params, per-layer views, encoder views) of the last parameter tree
    # decoded from
    _views: Optional[Tuple[Dict, List[Dict], List[Dict]]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.cfg.family not in ("dense", "moe", "vlm", "encdec", "ssm",
                                   "hybrid"):
            raise ValueError(self.cfg.family)

    def _hybrid_shape(self) -> Tuple[int, int, int]:
        """(layers per group, groups, tail layers) of the hybrid stack."""
        cfg = self.cfg
        g = cfg.pattern_rec + cfg.pattern_attn
        groups = cfg.n_layers // g
        return g, groups, cfg.n_layers - groups * g

    # ------------------------------------------------------------------ init
    def init(self, gen: Optional[torch.Generator] = None) -> Dict:
        """Random parameters from ``gen`` (a generator on this LM's
        device; seed 0 when none is given), in the reference's tree.
        The reference draws from JAX's PRNG, which torch cannot
        reproduce: parity runs pass the reference's parameters in
        (``interop.params_from_numpy``)."""
        return tree_map_with_path(
            lambda _, leaf: leaf.draw() if is_draw(leaf) else leaf,
            self.init_lazy(gen))

    def init_lazy(self, gen: Optional[torch.Generator] = None) -> Dict:
        """``init``'s tree with every normal leaf a ``Draw`` not drawn
        yet: ``init`` draws them whole in the tree's order;
        ``core.compress.repack`` draws those its plan packs one slice at
        a time straight into their packed words (a packing
        ``ServeEngine``), so the dense tree never exists."""
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
        fam, n = cfg.family, cfg.n_layers
        if fam in ("dense", "vlm"):
            params["blocks"] = {"attn": B.init_attention(gen, cfg, n),
                                "mlp": B.init_mlp(gen, cfg, n)}
        elif fam == "moe":
            params["blocks"] = {"attn": B.init_attention(gen, cfg, n),
                                "moe": B.init_moe(gen, cfg, n)}
        elif fam == "ssm":
            params["blocks"] = {"mamba": B.init_mamba(gen, cfg, n)}
        elif fam == "hybrid":
            g, groups, tail = self._hybrid_shape()
            params["blocks"] = {
                "rec": B.init_rglru(gen, cfg, (groups, cfg.pattern_rec)),
                "attn": B.init_attention(gen, cfg, groups),
                "mlp": B.init_mlp(gen, cfg, (groups, g)),
            }
            if tail:
                params["tail"] = {"rec": B.init_rglru(gen, cfg, tail),
                                  "mlp": B.init_mlp(gen, cfg, tail)}
        else:                                           # encdec
            params["enc_blocks"] = {
                "attn": B.init_attention(gen, cfg, cfg.encoder_layers),
                "mlp": B.init_mlp(gen, cfg, cfg.encoder_layers)}
            params["blocks"] = {"self": B.init_attention(gen, cfg, n),
                                "cross": B.init_attention(gen, cfg, n),
                                "mlp": B.init_mlp(gen, cfg, n)}
            params["enc_norm"] = torch.zeros((cfg.d_model,), dtype=dt,
                                             device=self.device)
        return params

    def logits_fn(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = L.rms_norm(x, params["final_norm"])
        head = params["embed"] if cfg.tie_embeddings else params["lm_head"]
        return L.unembed(x, head, cfg.tie_embeddings)

    # -------------------------------------------------------------- forward
    def _positions(self, batch_size: int, s: int) -> torch.Tensor:
        return torch.arange(s, device=self.device)[None].expand(batch_size,
                                                                s)

    def _backbone(self, params, x: torch.Tensor, positions: torch.Tensor,
                  prefix: int = 0,
                  enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every layer over the sequence x (B, S, d), in
        ``_layer_views``' order."""
        cfg = self.cfg
        fam = cfg.family
        for lp in self.layer_params(params):
            if fam == "ssm":
                x = B.mamba_apply(lp["mamba"], x, cfg)
                continue
            if "rec" in lp:
                x = B.rglru_apply(lp["rec"], x, cfg)
            elif fam == "hybrid":
                x = B.attention_apply(lp["attn"], x, cfg, positions,
                                      window=cfg.attn_window)
            elif fam == "encdec":
                x = B.attention_apply(lp["self"], x, cfg, positions)
                x = B.attention_apply(lp["cross"], x, cfg, positions,
                                      kv_source=enc_out, use_rope=False)
            else:
                x = B.attention_apply(lp["attn"], x, cfg, positions,
                                      prefix=prefix)
            if fam == "moe":
                x = B.moe_apply(lp["moe"], x, cfg)
            else:
                x = B.mlp_apply(lp["mlp"], x, cfg)
        return x

    def _encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """The encdec encoder over stub frame embeddings (B, Se, d):
        roped, non-causal self-attention and an MLP per layer, then
        ``enc_norm``."""
        cfg = self.cfg
        x = frames.to(device=self.device, dtype=cfg.compute_dtype)
        pos = self._positions(x.shape[0], x.shape[1])
        for lp in self.encoder_params(params):
            x = B.attention_apply(lp["attn"], x, cfg, pos, causal=False)
            x = B.mlp_apply(lp["mlp"], x, cfg)
        return L.rms_norm(x, params["enc_norm"])

    def _embed_inputs(self, params, batch: Dict
                      ) -> Tuple[torch.Tensor, int, Optional[torch.Tensor]]:
        """(hidden (B, S, d), prefix length, encoder output) of a batch
        dict of any family."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = L.embed(tokens, params["embed"]).to(cfg.compute_dtype)
        prefix, enc_out = 0, None
        if cfg.family == "vlm":
            img = torch.as_tensor(batch["patch_embeds"], device=self.device)
            x = torch.cat([img.to(cfg.compute_dtype), x], dim=1)
            prefix = cfg.num_image_tokens
        if cfg.family == "encdec":
            enc_out = self._encode(params, torch.as_tensor(batch["frames"]))
        return x, prefix, enc_out

    def _forward(self, params, batch: Dict) -> Tuple[torch.Tensor, int]:
        x, prefix, enc_out = self._embed_inputs(params, batch)
        positions = self._positions(x.shape[0], x.shape[1])
        return self._backbone(params, x, positions, prefix, enc_out), prefix

    def loss(self, params, batch: Dict, s_chunk: int = 512) -> torch.Tensor:
        """Mean next-token cross entropy in f32 over ``labels`` (B, S),
        the logits made ``s_chunk`` positions at a time. As the
        reference does, only the ``S // s_chunk`` whole chunks are
        summed, over B S."""
        h, prefix = self._forward(params, batch)
        if prefix:
            h = h[:, prefix:]
        labels = torch.as_tensor(batch["labels"], device=self.device).long()
        b, s = labels.shape
        s_chunk = min(s_chunk, s)
        tot = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(s // s_chunk):
            cut = slice(i * s_chunk, (i + 1) * s_chunk)
            logits = self.logits_fn(params, h[:, cut]).float()
            gold = logits.gather(-1, labels[:, cut, None])[..., 0]
            tot = tot + (torch.logsumexp(logits, dim=-1) - gold).sum()
        return tot / (b * s)

    def prefill(self, params, batch: Dict) -> Tuple[torch.Tensor, Dict]:
        """The whole prompt; returns the last position's logits (B, 1, V)
        and no decode state."""
        h, _ = self._forward(params, batch)
        return self.logits_fn(params, h[:, -1:]), {}

    def input_specs(self, shape: ShapeConfig
                    ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """(shape, dtype) of every model input of a shape cell, nothing
        allocated: tokens (and labels to train; the vlm's patch
        embeddings, encdec's frames) for a train or prefill cell, one
        new token per sequence to decode."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        if shape.kind not in ("train", "prefill"):
            return {"tokens": ((b, 1), torch.int32)}
        specs = {"tokens": ((b, s), torch.int32)}
        if shape.kind == "train":
            specs["labels"] = ((b, s), torch.int32)
        if cfg.family == "vlm":
            specs["patch_embeds"] = ((b, cfg.num_image_tokens, cfg.d_model),
                                     torch.float32)
        if cfg.family == "encdec":
            specs["frames"] = ((b, cfg.encoder_seq, cfg.d_model),
                               torch.float32)
        return specs

    # --------------------------------------------------------------- decode
    @property
    def supports_rollback(self) -> bool:
        """True when the decode state is KV rows and a length, so that a
        speculative reject is a length reset; the recurrent families
        fold every token into state that cannot be un-folded."""
        return not self.cfg.recurrent

    def _kv_segment_layout(self) -> Optional[Tuple[Tuple[int, int, int], ...]]:
        """``cfg.kv_segments()`` when the config carries per-layer KV
        widths (checked as the reference checks them), else None: the
        uniform single-buffer layout."""
        cfg = self.cfg
        klb = cfg.compression.kv_layer_bits
        if klb is None:
            return None
        if cfg.family not in ("dense", "vlm", "moe"):
            raise Refused(
                f"kv_layer_bits is only supported for dense/vlm/moe "
                f"decode stacks, not family {cfg.family!r}")
        if len(klb) != cfg.n_kv_layers:
            raise Refused(f"kv_layer_bits has {len(klb)} entries for "
                             f"{cfg.n_kv_layers} KV layers")
        if not cfg.compression.kv_bits:
            raise Refused(
                "kv_layer_bits requires kv_bits (set it to the max "
                "per-layer width; None means a dense, unpacked cache)")
        if max(klb) != cfg.compression.kv_bits:
            raise Refused(f"kv_bits ({cfg.compression.kv_bits}) must "
                             f"equal max(kv_layer_bits) = {max(klb)}")
        return cfg.kv_segments()

    def _kv(self, layers: int, rows: Tuple[int, ...],
            bits: Optional[int], names=("k", "v")) -> Dict:
        """Zeroed buffers of (layers, *rows, Hkv, W) under ``names``:
        int32 words when the KV packs at ``bits``, else (..., Hkv, D) in
        the compute dtype."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        shape = (layers, *rows, cfg.n_kv_heads,
                 bitpack.packed_group_words(hd, bits) if bits else hd)
        dt = torch.int32 if bits else cfg.compute_dtype
        return {name: torch.zeros(shape, dtype=dt, device=self.device)
                for name in names}

    def _kv_buffers(self, rows: Tuple[int, ...]):
        """K and V buffers of (n_layers, *rows, Hkv, W): one stacked
        dict, or a tuple of them per width segment."""
        segs = self._kv_segment_layout()
        if segs is None:
            return self._kv(self.cfg.n_layers, rows,
                            self.cfg.compression.kv_bits)
        return tuple(self._kv(hi - lo, rows, bits) for lo, hi, bits in segs)

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

    def _cross_state(self, batch_size: int) -> Dict:
        """The encdec cross cache {ck, cv} of (L, B, encoder_seq, Hkv, W)
        (dense in both layouts: it is prompt-scoped and fixed-size) and
        ``clen``."""
        cfg = self.cfg
        return {"cross": self._kv(cfg.n_layers, (batch_size, cfg.encoder_seq),
                                  cfg.compression.kv_bits, ("ck", "cv")),
                "clen": torch.zeros((batch_size,), dtype=torch.int32,
                                    device=self.device)}

    def _recurrent(self, lead: Tuple[int, ...], width: int,
                   last: Tuple[int, ...], name: str) -> Dict:
        """Zeroed recurrent state: ``conv`` (*lead, d_conv-1, width) in
        the compute dtype and ``name`` (*lead, *last) in f32."""
        cfg = self.cfg
        return {"conv": torch.zeros(lead + (cfg.d_conv - 1, width),
                                    dtype=cfg.compute_dtype,
                                    device=self.device),
                name: torch.zeros(lead + last, dtype=torch.float32,
                                  device=self.device)}

    def init_decode_state(self, batch_size: int, seq_len: int) -> Dict:
        """Zeroed decode state: ``len`` (B,) int32 and, by family, the
        cache ``kv`` {k, v} of (L, B, S, Hkv, W) (or a tuple of such
        dicts per width segment), encdec's cross cache and ``clen``,
        ssm's ``conv`` and ``ssm``, hybrid's ring ``kv`` of (groups, B,
        min(window, S), Hkv, W), ``rec`` {conv, h} of (groups,
        pattern_rec, B, ...) and ``tail_rec``."""
        cfg = self.cfg
        self._kv_segment_layout()      # raises as the reference's does
        b = batch_size
        state: Dict[str, Any] = {
            "len": torch.zeros((b,), dtype=torch.int32, device=self.device)}
        fam = cfg.family
        if fam in ("dense", "vlm", "moe"):
            state["kv"] = self._kv_buffers((b, seq_len))
        elif fam == "ssm":
            state.update(self._recurrent((cfg.n_layers, b), cfg.d_inner,
                                         (cfg.d_inner, cfg.ssm_state), "ssm"))
        elif fam == "hybrid":
            _, groups, tail = self._hybrid_shape()
            lw = cfg.lru_width or cfg.d_model
            win = min(cfg.attn_window or seq_len, seq_len)
            state["kv"] = self._kv(groups, (b, win), cfg.compression.kv_bits)
            state["rec"] = self._recurrent((groups, cfg.pattern_rec, b), lw,
                                           (lw,), "h")
            if tail:
                state["tail_rec"] = self._recurrent((tail, b), lw, (lw,),
                                                    "h")
        else:                                           # encdec
            state["kv"] = self._kv_buffers((b, seq_len))
            state.update(self._cross_state(b))
        return state

    def init_paged_decode_state(self, batch_size: int, seq_len: int,
                                page_size: int, n_pages: int) -> Dict:
        """Zeroed paged decode state: ``len`` (B,) int32, the page
        ``table`` (B, seq_len // page_size) int32, and the pools ``kv``
        {k, v} of (L, n_pages + 1, page_size, Hkv, W) (a tuple of them
        per width segment, over the same page axis); page 0 is the scrap
        page, the target of every unallocated table entry. ``page_size``
        must divide ``seq_len``, so the pages a table row names span the
        dense cache's S rows. encdec's cross cache stays dense. The
        recurrent families have no rows to page and raise."""
        if not self.supports_rollback:
            raise Refused(
                f"family {self.cfg.family!r} carries recurrent decode state; "
                "paged KV needs a row-addressable cache (use dense mode)")
        if seq_len % page_size:
            raise Refused(
                f"kv_page_size {page_size} must divide max_seq_len "
                f"{seq_len} so gathered pages keep the dense cache shape")
        state = {
            "len": torch.zeros((batch_size,), dtype=torch.int32,
                               device=self.device),
            "table": torch.zeros((batch_size, seq_len // page_size),
                                 dtype=torch.int32, device=self.device),
            "kv": self._kv_buffers((n_pages + 1, page_size)),
        }
        if self.cfg.family == "encdec":
            state.update(self._cross_state(batch_size))
        return state

    def _layer_views(self, params: Dict) -> List[Dict]:
        """One view per layer, in the order the decode body runs them.
        Hybrid: per group, its ``pattern_rec`` {rec, mlp} layers and one
        {attn, mlp} layer (its nested stacks sliced twice), then the
        tail's {rec, mlp} layers."""
        cfg = self.cfg
        if cfg.family != "hybrid":
            return [layer_slice(params["blocks"], i)
                    for i in range(cfg.n_layers)]
        blocks = params["blocks"]
        _, groups, tail = self._hybrid_shape()
        views = []
        for j in range(groups):
            rec, mlp = (layer_slice(blocks["rec"], j),
                        layer_slice(blocks["mlp"], j))
            views += [{"rec": layer_slice(rec, i), "mlp": layer_slice(mlp, i)}
                      for i in range(cfg.pattern_rec)]
            views.append({"attn": layer_slice(blocks["attn"], j),
                          "mlp": layer_slice(mlp, cfg.pattern_rec)})
        views += [layer_slice(params["tail"], t) for t in range(tail)]
        return views

    def _views_of(self, params: Dict) -> Tuple[Dict, List[Dict], List[Dict]]:
        """(params, decoder views, encoder views): stacked leaves sliced
        (a stacked (L, E, K, N) expert bank gives a 3-D bank per layer),
        and the packed leaves no kernel takes (``blocks.PLAIN_LEAVES``:
        norm scales, conv, SSM and RG-LRU diagonals, which the reference
        decodes on every step) decoded with the plain decode. A serving
        tree is read-only, so its views are built once and kept. A
        training tree (``_trainable``) gets new views on every call and
        none is kept: they would hold the last step's autograd graph and
        a decode of masters since updated in place; its ``STWeight``
        leaves decode straight through."""
        if self._views is not None and self._views[0] is params:
            return self._views
        def decode_plain(path, leaf):
            if (is_packed(leaf) or is_st(leaf)) and path[-1] in B.PLAIN_LEAVES:
                return L.unpack_maybe(leaf)
            return leaf
        def decoded(views):
            return [tree_map_with_path(decode_plain, v) for v in views]
        enc = [layer_slice(params["enc_blocks"], i)
               for i in range(self.cfg.encoder_layers)
               ] if "enc_blocks" in params else []
        views = (params, decoded(self._layer_views(params)), decoded(enc))
        self._views = None if _trainable(params) else views
        return views

    def layer_params(self, params: Dict) -> List[Dict]:
        """Every layer's parameters (``_layer_views``), once per tree
        (``_views_of``)."""
        return self._views_of(params)[1]

    def encoder_params(self, params: Dict) -> List[Dict]:
        """The encdec encoder's layers, once per tree (``_views_of``)."""
        return self._views_of(params)[2]

    def _self_attention(self, lp: Dict, x: torch.Tensor, state: Dict,
                        layer_kv: Dict, bits: Optional[int]) -> torch.Tensor:
        """One layer's causal self-attention over ``layer_kv`` (its {k, v}
        cache or pools), appending this token's row at ``len``: dense,
        through the table (fused) or by the gather route."""
        cfg, lens, table = self.cfg, state["len"], state.get("table")
        positions = lens[:, None]
        if table is None:
            x, _ = B.attention_decode(lp, x, cfg, dict(layer_kv, len=lens),
                                      positions, kv_bits=bits)
        elif self.paged_attn:
            x, _ = B.attention_decode_paged(lp, x, cfg, layer_kv, table, lens,
                                            positions, kv_bits=bits)
        else:
            st = {"k": gather_kv_pages(layer_kv["k"], table),
                  "v": gather_kv_pages(layer_kv["v"], table), "len": lens}
            x, st = B.attention_decode(lp, x, cfg, st, positions,
                                       kv_bits=bits)
            for name in ("k", "v"):
                scatter_kv_row(layer_kv[name], st[name], table, lens)
        return x

    def _hidden(self, params, state: Dict,
                tokens: torch.Tensor) -> torch.Tensor:
        """The decode body: embed, every layer (appending this token's KV
        row at ``len``, stepping the recurrent state in place), the final
        hidden state (B, 1, d)."""
        cfg = self.cfg
        fam = cfg.family
        x = L.embed(tokens, params["embed"]).to(cfg.compute_dtype)
        views = self.layer_params(params)
        if fam in ("dense", "vlm", "moe", "encdec"):
            for i, (lp, (seg, j, bits)) in enumerate(
                    zip(views, self._kv_layers(state["kv"]))):
                layer_kv = {"k": seg["k"][j], "v": seg["v"][j]}
                x = self._self_attention(lp["self" if fam == "encdec"
                                            else "attn"],
                                         x, state, layer_kv, bits)
                if fam == "encdec":
                    cross = {"ck": state["cross"]["ck"][i],
                             "cv": state["cross"]["cv"][i],
                             "clen": state["clen"]}
                    x, _ = B.attention_decode(lp["cross"], x, cfg, cross,
                                              None, kv_bits=bits, cross=True)
                if fam == "moe":
                    x = B.moe_apply(lp["moe"], x, cfg)
                else:
                    x = B.mlp_apply(lp["mlp"], x, cfg)
        elif fam == "ssm":
            for i, lp in enumerate(views):
                st = {"conv": state["conv"][i], "ssm": state["ssm"][i]}
                x, new = B.mamba_decode(lp["mamba"], x, cfg, st)
                for name in ("conv", "ssm"):        # in place
                    st[name].copy_(new[name])
        else:                                           # hybrid
            x = self._hybrid_hidden(views, state, x)
        return x

    def _hybrid_hidden(self, views: List[Dict], state: Dict,
                       x: torch.Tensor) -> torch.Tensor:
        """The hybrid body over ``_layer_views``' order: RG-LRU layers
        step ``rec`` (then ``tail_rec``) in place, each group's attention
        layer appends to its ring at ``len % attn_window``."""
        cfg = self.cfg
        g, groups, _ = self._hybrid_shape()
        lens, kv = state["len"], state["kv"]
        for n, lp in enumerate(views):
            j, i = divmod(n, g)
            if "attn" in lp:
                st = {"k": kv["k"][j], "v": kv["v"][j], "len": lens}
                x, _ = B.attention_decode(lp["attn"], x, cfg, st,
                                          lens[:, None],
                                          kv_bits=cfg.compression.kv_bits,
                                          window=cfg.attn_window)
            else:
                if j < groups:
                    st = {"conv": state["rec"]["conv"][j, i],
                          "h": state["rec"]["h"][j, i]}
                else:
                    t = n - groups * g
                    st = {"conv": state["tail_rec"]["conv"][t],
                          "h": state["tail_rec"]["h"][t]}
                x, new = B.rglru_decode(lp["rec"], x, cfg, st)
                for name in ("conv", "h"):          # in place
                    st[name].copy_(new[name])
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
        ``len`` are dead, so this is a length reset. The recurrent
        families raise."""
        if not self.supports_rollback:
            raise Refused(
                f"family {self.cfg.family!r} carries recurrent decode "
                "state; KV-length rollback cannot undo folded tokens")
        return dict(state, len=torch.as_tensor(
            lengths, dtype=torch.int32, device=self.device))
