"""Transformer blocks: init and single-token decode.

Port of the attention, MLP and MoE parts of ``repro.models.blocks``.
``init_*`` returns the parameters of all ``n`` layers stacked on a
leading axis (the reference stacks per-layer inits with ``vmap``);
``*_decode`` / ``mlp_apply`` / ``moe_apply`` take one layer's slice.
Mamba and RG-LRU blocks come with ROADMAP A12.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.attention import (append_kv_pool_row,
                                          decode_attention,
                                          paged_decode_attention,
                                          update_kv_cache)
from repro_torch.models.config import ModelConfig


def init_attention(gen: torch.Generator, cfg: ModelConfig, n: int) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.compute_dtype
    p = {
        "wq": L.init_dense(gen, (n, d, h * hd), dtype=dt),
        "wk": L.init_dense(gen, (n, d, hkv * hd), dtype=dt),
        "wv": L.init_dense(gen, (n, d, hkv * hd), dtype=dt),
        "wo": L.init_dense(gen, (n, h * hd, d), dtype=dt),
        "ln": torch.zeros((n, d), dtype=dt, device=gen.device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((n, hd), dtype=dt, device=gen.device)
        p["k_norm"] = torch.zeros((n, hd), dtype=dt, device=gen.device)
    return p


def _project_qkv(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """The decode step's q (B, 1, H, D), k and v (B, 1, Hkv, D): norms,
    projections and rope."""
    b = x.shape[0]
    hd, h, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    xn = L.rms_norm(x, p["ln"])
    q = L.linear(xn, p["wq"]).reshape(b, 1, h, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
    k = L.linear(xn, p["wk"]).reshape(b, 1, hkv, hd)
    v = L.linear(xn, p["wv"]).reshape(b, 1, hkv, hd)
    if cfg.qk_norm:
        k = L.rms_norm(k, p["k_norm"])
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_out(p: Dict, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Residual plus the output projection of o (B, H, D)."""
    return x + L.linear(o.reshape(x.shape[0], 1, -1), p["wo"],
                        "...f,fd->...d")


def attention_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                     state: Dict, positions: torch.Tensor, kv_bits: int
                     ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d); state {k, v, len}: one layer's cache, appended in
    place at ``len`` and packed at ``kv_bits`` (the layer's own width
    under per-layer KV widths)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    kc, vc = update_kv_cache(state["k"], state["v"], k[:, 0], v[:, 0],
                             state["len"], kv_bits)
    o = decode_attention(q[:, 0], kc, vc, state["len"] + 1, kv_bits)
    return _attn_out(p, x, o), dict(state, k=kc, v=vc)


def attention_decode_paged(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                           kv: Dict, table: torch.Tensor,
                           kv_len: torch.Tensor, positions: torch.Tensor,
                           kv_bits: int) -> Tuple[torch.Tensor, Dict]:
    """The paged twin of ``attention_decode``: the same q/k/v program,
    the new row written straight to its physical page of ``kv`` (one
    layer's pools {k, v} of (P+1, page, Hkv, W), in place), attention
    through the page table ``table``."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    kc, vc = append_kv_pool_row(kv["k"], kv["v"], k[:, 0], v[:, 0], table,
                                kv_len, kv_bits)
    o = paged_decode_attention(q[:, 0], kc, vc, table, kv_len + 1, kv_bits)
    return _attn_out(p, x, o), {"k": kc, "v": vc}


def init_mlp(gen: torch.Generator, cfg: ModelConfig, n: int) -> Dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.compute_dtype
    p = {
        "w_in": L.init_dense(gen, (n, d, f), dtype=dt),
        "w_out": L.init_dense(gen, (n, f, d), dtype=dt),
        "ln": torch.zeros((n, d), dtype=dt, device=gen.device),
    }
    if cfg.gated_mlp:
        p["w_gate"] = L.init_dense(gen, (n, d, f), dtype=dt)
    return p


def mlp_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xn = L.rms_norm(x, p["ln"])
    return x + L.mlp(xn, p["w_in"], p.get("w_gate"), p["w_out"],
                     cfg.gated_mlp)


def init_moe(gen: torch.Generator, cfg: ModelConfig, n: int) -> Dict:
    d, f, dt = cfg.d_model, cfg.moe_d_ff, cfg.compute_dtype
    e = cfg.n_experts
    p = {
        "router": L.init_dense(gen, (n, d, e), scale=0.02,
                               dtype=torch.float32),
        "experts": {
            "w_in": L.init_dense(gen, (n, e, d, f), dtype=dt),
            "w_gate": L.init_dense(gen, (n, e, d, f), dtype=dt),
            "w_out": L.init_dense(gen, (n, e, f, d), dtype=dt),
        },
        "ln": torch.zeros((n, d), dtype=dt, device=gen.device),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {
            "w_in": L.init_dense(gen, (n, d, fs), dtype=dt),
            "w_gate": L.init_dense(gen, (n, d, fs), dtype=dt),
            "w_out": L.init_dense(gen, (n, fs, d), dtype=dt),
        }
    if cfg.dense_residual:
        p["residual"] = {
            "w_in": L.init_dense(gen, (n, d, cfg.d_ff), dtype=dt),
            "w_gate": L.init_dense(gen, (n, d, cfg.d_ff), dtype=dt),
            "w_out": L.init_dense(gen, (n, cfg.d_ff, d), dtype=dt),
        }
    return p


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Rows per expert when ``tokens`` are routed."""
    return int(math.ceil(tokens * cfg.experts_per_token / cfg.n_experts
                         * cfg.capacity_factor))


def route(p: Dict, xf: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """The router on xf (t, d): softmax gates in f32, the top-k choices
    per token with their weights renormalised, and the capacity.
    Returns (top_w (t, k) f32, top_i (t, k), cap)."""
    gates = torch.softmax(L.linear(xf.float(), p["router"]), dim=-1)
    # jax.lax.top_k breaks ties toward the lower index; a stable
    # descending sort does the same (torch.topk promises no tie order)
    top_w, top_i = torch.sort(gates, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    top_w, top_i = top_w[:, :k], top_i[:, :k]
    top_w = top_w / top_w.sum(-1, keepdim=True).clamp(min=1e-9)
    return top_w, top_i, capacity(cfg, xf.shape[0])


def moe_ffn(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Top-k routing with per-expert capacity, as the reference's
    scatter-based dispatch: every token of x (B, S, d) is routed (idle
    and padding slots included), choices past an expert's capacity are
    dropped, and the three expert products run on (E, cap, d) buffers
    through ``expert_linear``. The routing glue is plain PyTorch."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d)
    top_w, top_i, cap = route(p, xf, cfg)

    flat_e = top_i.reshape(-1)                        # (t*k,) token-major
    onehot = F.one_hot(flat_e, e)
    pos_in_e = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
    keep = pos_in_e < cap
    slot = torch.where(keep, flat_e * cap + pos_in_e, e * cap)

    # kept slots are distinct; dropped choices all add into row e*cap,
    # which is thrown away
    x_rep = xf.repeat_interleave(k, dim=0)            # (t*k, d)
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_add_(0, slot, x_rep)
    ein = buf[:e * cap].reshape(e, cap, d)

    we = p["experts"]
    h = L.expert_linear(ein, we["w_in"])
    g = L.expert_linear(ein, we["w_gate"])
    h = F.silu(g) * h
    eout = L.expert_linear(h, we["w_out"])

    flat_out = torch.cat([eout.reshape(e * cap, d),
                          eout.new_zeros((1, d))], 0)
    y_rep = flat_out[slot] * (top_w.reshape(-1)[:, None].to(x.dtype)
                              * keep[:, None].to(x.dtype))
    return y_rep.reshape(t, k, d).sum(1).reshape(b, s, d)


def moe_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xn = L.rms_norm(x, p["ln"])
    y = moe_ffn(p, xn, cfg)
    for name in ("shared", "residual"):
        if name in p:
            sp = p[name]
            y = y + L.mlp(xn, sp["w_in"], sp.get("w_gate"), sp["w_out"], True)
    return x + y
