"""Model assembly for the dense and MoE families: init, decode state,
decode steps.

Port of the serving surface of ``repro.models.lm.LM``:

  * ``init(gen)``                          -> params (stacked (L, ...) leaves)
  * ``init_decode_state(batch, seq_len)``  -> zeroed dense per-slot KV state
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
per-layer 3-D banks. Other families come with ROADMAP A12,
per-layer KV widths with A11 and paged state with A10.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core import bitpack
from repro_torch.core.tensor_store import is_packed, tree_map_with_path
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def layer_slice(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a stacked (L, ...) parameter tree."""
    return tree_map_with_path(
        lambda _, leaf: leaf.layer(i) if is_packed(leaf) else leaf[i], tree)


@dataclasses.dataclass
class LM:
    cfg: ModelConfig
    device: Optional[Union[str, torch.device]] = None
    # (params, per-layer views) of the last parameter tree decoded from
    _views: Optional[Tuple[Dict, List[Dict]]] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.cfg.family not in ("dense", "moe"):
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet (ROADMAP A12)")
        if self.cfg.compression.kv_layer_bits is not None:
            raise NotImplementedError(
                "per-layer KV widths are not ported yet (ROADMAP A11)")

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
    def init_decode_state(self, batch_size: int, seq_len: int) -> Dict:
        """Zeroed decode state: ``len`` (B,) int32 and the stacked cache
        ``kv`` {k, v} of (L, B, S, Hkv, W) int32 words when the KV packs,
        else (L, B, S, Hkv, D) in the compute dtype."""
        cfg = self.cfg
        hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
        bits = cfg.compression.kv_bits
        if bits:
            shape = (cfg.n_layers, batch_size, seq_len, hkv,
                     bitpack.packed_group_words(hd, bits))
            dt = torch.int32
        else:
            shape = (cfg.n_layers, batch_size, seq_len, hkv, hd)
            dt = cfg.compute_dtype
        return {
            "len": torch.zeros((batch_size,), dtype=torch.int32,
                               device=self.device),
            "kv": {"k": torch.zeros(shape, dtype=dt, device=self.device),
                   "v": torch.zeros(shape, dtype=dt, device=self.device)},
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
        row at ``len``), the final hidden state (B, 1, d)."""
        cfg = self.cfg
        x = L.embed(tokens, params["embed"]).to(cfg.compute_dtype)
        positions = state["len"][:, None]
        kv = state["kv"]
        for i, lp in enumerate(self.layer_params(params)):
            st = {"k": kv["k"][i], "v": kv["v"][i], "len": state["len"]}
            x, _ = B.attention_decode(lp["attn"], x, cfg, st, positions)
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
