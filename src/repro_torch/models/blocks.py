"""Dense transformer blocks: init and single-token decode.

Port of the dense-attention and MLP parts of ``repro.models.blocks``.
``init_*`` returns the parameters of all ``n`` layers stacked on a
leading axis (the reference stacks per-layer inits with ``vmap``);
``*_decode`` / ``mlp_apply`` take one layer's slice. MoE, Mamba and
RG-LRU blocks come with ROADMAP A12.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.attention import decode_attention, update_kv_cache
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


def attention_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                     state: Dict, positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d); state {k, v, len}: one layer's cache, appended in
    place at ``len``."""
    b = x.shape[0]
    hd, h, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    xn = L.rms_norm(x, p["ln"])
    q = L.linear(xn, p["wq"]).reshape(b, 1, h, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
    kv_bits = cfg.compression.kv_bits
    k = L.linear(xn, p["wk"]).reshape(b, 1, hkv, hd)
    v = L.linear(xn, p["wv"]).reshape(b, 1, hkv, hd)
    if cfg.qk_norm:
        k = L.rms_norm(k, p["k_norm"])
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    kc, vc = update_kv_cache(state["k"], state["v"], k[:, 0], v[:, 0],
                             state["len"], kv_bits)
    o = decode_attention(q[:, 0], kc, vc, state["len"] + 1, kv_bits)
    out = x + L.linear(o.reshape(b, 1, h * hd), p["wo"], "...f,fd->...d")
    return out, dict(state, k=kc, v=vc)


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
