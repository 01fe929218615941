"""Blocks of every family: init, the forward over a sequence and
single-token decode.

Port of ``repro.models.blocks``: attention (causal, windowed or cross),
MLP, MoE, Mamba-1 and RG-LRU. ``init_*`` returns the parameters of every
layer stacked on leading axes ``n`` (an int, or a tuple for the hybrid
family's (groups, per group) stacks; the reference stacks per-layer
inits with ``vmap``), each random leaf a ``Draw`` that ``LM.init`` or a
packing engine draws; ``*_apply`` (over a sequence (B, S, d): prefill
and the loss) and ``*_decode`` (one token) take one layer's slice, and
``mlp_apply`` / ``moe_apply`` serve both. The recurrences of
``mamba_apply`` and ``rglru_apply`` are loops over S in f32, and
autograd differentiates them as they stand (as it does the MoE router
and its capacity drop). The reference checkpoints them in chunks and
remats every layer; the port keeps its activations instead, which
changes memory, not values.

The leaves named in ``PLAIN_LEAVES`` are read whole through
``layers.unpack_maybe``, as the reference reads them: norm scales, the
depthwise conv, the SSM and RG-LRU diagonals. No kernel takes them, so
``LM.layer_params`` decodes a packed one once per serving tree, and an
``STWeight`` one straight through on every training step.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.attention import (append_kv_pool_row,
                                          decode_attention, flash_attention,
                                          paged_decode_attention,
                                          update_kv_cache)
from repro_torch.models.config import ModelConfig


PLAIN_LEAVES = frozenset({"ln", "q_norm", "k_norm", "conv_w", "conv_b",
                          "dt_bias", "a_param", "d_param", "rg_a", "rg_wr",
                          "rg_wi"})

Stack = Union[int, Tuple[int, ...]]


def _lead(n: Stack) -> Tuple[int, ...]:
    return (n,) if isinstance(n, int) else tuple(n)


def _full(gen: torch.Generator, n: Stack, shape, value: float,
          dtype: torch.dtype) -> torch.Tensor:
    return torch.full(_lead(n) + tuple(shape), value, dtype=dtype,
                      device=gen.device)


def init_attention(gen: torch.Generator, cfg: ModelConfig, n: Stack) -> Dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    h, hkv = cfg.n_heads, cfg.n_kv_heads
    dt, s = cfg.compute_dtype, _lead(n)
    p = {
        "wq": L.init_dense(gen, s + (d, h * hd), dtype=dt),
        "wk": L.init_dense(gen, s + (d, hkv * hd), dtype=dt),
        "wv": L.init_dense(gen, s + (d, hkv * hd), dtype=dt),
        "wo": L.init_dense(gen, s + (h * hd, d), dtype=dt),
        "ln": _full(gen, n, (d,), 0.0, dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = _full(gen, n, (hd,), 0.0, dt)
        p["k_norm"] = _full(gen, n, (hd,), 0.0, dt)
    return p


def attention_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, causal: bool = True,
                    window: int = 0, prefix: int = 0,
                    kv_source: Optional[torch.Tensor] = None,
                    use_rope: bool = True) -> torch.Tensor:
    """x (B, S, d) -> x plus attention over the sequence: self-attention
    (rope at ``positions``, causal, within ``window``), or cross
    attention over ``kv_source`` (B, Se, d), which is neither roped nor
    causal. ``prefix`` is accepted and, as in the reference, not passed
    on: a vlm's image tokens attend causally."""
    b, s, _ = x.shape
    hd, h, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    xn = L.rms_norm(x, p["ln"])
    src = xn if kv_source is None else kv_source
    q = L.linear(xn, p["wq"]).reshape(b, s, h, hd)
    k = L.linear(src, p["wk"]).reshape(b, src.shape[1], hkv, hd)
    v = L.linear(src, p["wv"]).reshape(b, src.shape[1], hkv, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
        k = L.rms_norm(k, p["k_norm"])
    if use_rope and kv_source is None:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal and kv_source is None,
                        window=window)
    return x + L.linear(o.reshape(b, s, h * hd), p["wo"], "...f,fd->...d")


def _project_q(p: Dict, x: torch.Tensor, cfg: ModelConfig):
    """(normed x, q (B, 1, H, D) before rope)."""
    xn = L.rms_norm(x, p["ln"])
    q = L.linear(xn, p["wq"]).reshape(x.shape[0], 1, cfg.n_heads,
                                      cfg.resolved_head_dim)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"])
    return xn, q


def _project_qkv(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """The decode step's q (B, 1, H, D), k and v (B, 1, Hkv, D): norms,
    projections and rope."""
    b = x.shape[0]
    hd, hkv = cfg.resolved_head_dim, cfg.n_kv_heads
    xn, q = _project_q(p, x, cfg)
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
                     state: Dict, positions: torch.Tensor, kv_bits: int,
                     window: int = 0, cross: bool = False
                     ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, 1, d). Self-attention: state {k, v, len}, one layer's
    cache packed at ``kv_bits`` (the layer's own width under per-layer
    KV widths), appended in place at ``len``, or with a ``window`` at
    ``len % window``, a ring of which ``min(len + 1, window)`` rows are
    read. Cross-attention (``cross``): state {ck, cv, clen}, q alone
    (no rope) over ``clen`` rows of the cross cache, which stays as it
    is."""
    if cross:
        _, q = _project_q(p, x, cfg)
        o = decode_attention(q[:, 0], state["ck"], state["cv"],
                             state["clen"], kv_bits)
        return _attn_out(p, x, o), state
    q, k, v = _project_qkv(p, x, cfg, positions)
    lens = state["len"]
    slot = lens % window if window else lens
    kc, vc = update_kv_cache(state["k"], state["v"], k[:, 0], v[:, 0], slot,
                             kv_bits)
    eff_len = lens + 1
    if window:
        eff_len = eff_len.clamp(max=window)
    o = decode_attention(q[:, 0], kc, vc, eff_len, kv_bits)
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


def init_mlp(gen: torch.Generator, cfg: ModelConfig, n: Stack) -> Dict:
    d, f, dt, s = cfg.d_model, cfg.d_ff, cfg.compute_dtype, _lead(n)
    p = {
        "w_in": L.init_dense(gen, s + (d, f), dtype=dt),
        "w_out": L.init_dense(gen, s + (f, d), dtype=dt),
        "ln": _full(gen, n, (d,), 0.0, dt),
    }
    if cfg.gated_mlp:
        p["w_gate"] = L.init_dense(gen, s + (d, f), dtype=dt)
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


# ---------------------------------------------------------------------------
# Mamba-1 (falcon-mamba) and RG-LRU (recurrentgemma)
# ---------------------------------------------------------------------------

SCAN_CHUNK = 256                 # positions whose SSM inputs are made at once

def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) with no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _conv_step(p: Dict, state: Dict, xi: torch.Tensor):
    """One step of the depthwise causal conv: the history (B, d_conv, C)
    of the state's trailing inputs and xi (B, 1, C), and its output
    (B, C) with the bias."""
    hist = torch.cat([state["conv"], xi], dim=1)
    w = L.unpack_maybe(p["conv_w"], xi.dtype)              # (C, d_conv)
    xc = (torch.einsum("bwc,cw->bc", hist, w)
          + L.unpack_maybe(p["conv_b"], xi.dtype))
    return hist, xc


def _causal_conv(x: torch.Tensor, w, b, width: int) -> torch.Tensor:
    """Depthwise causal conv over x (B, S, C), summed tap by tap in the
    reference's order."""
    wq = L.unpack_maybe(w, x.dtype)                          # (C, width)
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + x.shape[1], :] * wq[:, i][None, None, :]
              for i in range(width))
    return out + L.unpack_maybe(b, x.dtype)[None, None, :]


def init_mamba(gen: torch.Generator, cfg: ModelConfig, n: Stack) -> Dict:
    d, di, ns = cfg.d_model, cfg.d_inner, cfg.ssm_state
    dtr, dt, s = cfg.resolved_dt_rank, cfg.compute_dtype, _lead(n)
    f32 = torch.float32
    a_init = torch.log(torch.arange(1, ns + 1, dtype=f32,
                                    device=gen.device)).expand(s + (di, ns))
    return {
        "in_proj": L.init_dense(gen, s + (d, 2 * di), dtype=dt),
        "conv_w": L.init_dense(gen, s + (di, cfg.d_conv), dtype=dt),
        "conv_b": _full(gen, n, (di,), 0.0, dt),
        "x_proj": L.init_dense(gen, s + (di, dtr + 2 * ns), dtype=dt),
        "dt_proj": L.init_dense(gen, s + (dtr, di), dtype=dt),
        "dt_bias": _full(gen, n, (di,), 0.0, f32),
        "a_param": a_init.contiguous(),          # A = -exp(a_param), f32
        "d_param": _full(gen, n, (di,), 1.0, f32),
        "out_proj": L.init_dense(gen, s + (di, d), dtype=dt),
        "ln": _full(gen, n, (d,), 0.0, dt),
    }


def _ssm_params(p: Dict, xc: torch.Tensor, cfg: ModelConfig):
    """dt (f32, softplus), B and C (f32) and A = -exp(a_param) of xc."""
    dtr, ns = cfg.resolved_dt_rank, cfg.ssm_state
    bcdt = L.linear(xc, p["x_proj"], "...c,cf->...f")
    dt_r, bm, cm = torch.split(bcdt, [dtr, ns, ns], dim=-1)
    dt_full = L.linear(dt_r, p["dt_proj"], "...r,rc->...c")
    dt = _softplus(dt_full.float()
                   + L.unpack_maybe(p["dt_bias"], torch.float32))
    a = -torch.exp(L.unpack_maybe(p["a_param"], torch.float32))  # (di, n)
    return dt, bm.float(), cm.float(), a


def mamba_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, d): the Mamba-1 block over a sequence from a zero state.
    The selective scan steps h = exp(dt A) h + dt x B along S in f32,
    its per-step factors made SCAN_CHUNK positions at a time."""
    b, s, _ = x.shape
    xn = L.rms_norm(x, p["ln"])
    xi, z = L.linear(xn, p["in_proj"]).chunk(2, dim=-1)
    xc = F.silu(_causal_conv(xi, p["conv_w"], p["conv_b"], cfg.d_conv))
    dt, bm, cm, a = _ssm_params(p, xc, cfg)
    xcf = xc.float()
    h = torch.zeros((b, cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t0 in range(0, s, SCAN_CHUNK):
        dt_c = dt[:, t0:t0 + SCAN_CHUNK]
        da = torch.exp(dt_c[..., None] * a)                 # (B, c, di, n)
        dbx = ((dt_c * xcf[:, t0:t0 + SCAN_CHUNK])[..., None]
               * bm[:, t0:t0 + SCAN_CHUNK, None, :])
        for t in range(dt_c.shape[1]):
            h = da[:, t] * h + dbx[:, t]
            ys.append(torch.einsum("bcn,bn->bc", h, cm[:, t0 + t]))
    y = torch.stack(ys, dim=1) + xcf * L.unpack_maybe(p["d_param"],
                                                      torch.float32)
    y = y.to(x.dtype) * F.silu(z)
    return x + L.linear(y, p["out_proj"], "...c,cd->...d")


def mamba_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 state: Dict) -> Tuple[torch.Tensor, Dict]:
    """state: conv (B, d_conv-1, di) trailing inputs; ssm (B, di, n)."""
    xn = L.rms_norm(x, p["ln"])
    xi, z = L.linear(xn, p["in_proj"]).chunk(2, dim=-1)   # (B, 1, di)
    hist, xc = _conv_step(p, state, xi)
    xc = F.silu(xc)[:, None, :]
    dt, bm, cm, a = _ssm_params(p, xc, cfg)
    dt_t, b_t, c_t = dt[:, 0], bm[:, 0], cm[:, 0]
    xcf = xc[:, 0].float()
    da = torch.exp(dt_t[..., None] * a[None])
    h = da * state["ssm"] + (dt_t * xcf)[..., None] * b_t[:, None, :]
    y = (torch.einsum("bcn,bn->bc", h, c_t)
         + xcf * L.unpack_maybe(p["d_param"], torch.float32))
    y = y[:, None, :].to(x.dtype) * F.silu(z)
    out = x + L.linear(y, p["out_proj"], "...c,cd->...d")
    return out, dict(state, conv=hist[:, 1:], ssm=h)


RG_C = 8.0                                  # Griffin's fixed power


def init_rglru(gen: torch.Generator, cfg: ModelConfig, n: Stack) -> Dict:
    d, lw = cfg.d_model, cfg.lru_width or cfg.d_model
    dt, s, f32 = cfg.compute_dtype, _lead(n), torch.float32
    return {
        "rg_in_w": L.init_dense(gen, s + (d, lw), dtype=dt),
        "rg_gate_w": L.init_dense(gen, s + (d, lw), dtype=dt),
        "conv_w": L.init_dense(gen, s + (lw, cfg.d_conv), dtype=dt),
        "conv_b": _full(gen, n, (lw,), 0.0, dt),
        "rg_a": _full(gen, n, (lw,), -1.5, f32),    # sigmoid ~ 0.18
        "rg_wr": _full(gen, n, (lw,), 0.0, f32),    # diagonal gates
        "rg_wi": _full(gen, n, (lw,), 0.0, f32),
        "rg_out": L.init_dense(gen, s + (lw, d), dtype=dt),
        "ln": _full(gen, n, (d,), 0.0, dt),
    }


def _rglru_gates(p: Dict, xc: torch.Tensor):
    """(a, sqrt(1 - a^2) * i * x) in f32 for the conv output xc."""
    xf = xc.float()
    r = torch.sigmoid(xf * L.unpack_maybe(p["rg_wr"], torch.float32))
    i = torch.sigmoid(xf * L.unpack_maybe(p["rg_wi"], torch.float32))
    log_a = -RG_C * r * _softplus(L.unpack_maybe(p["rg_a"], torch.float32))
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, mult * i * xf


def rglru_apply(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, d): the RG-LRU block over a sequence from a zero state,
    h = a h + sqrt(1 - a^2) i x stepped along S in f32."""
    b, s, _ = x.shape
    xn = L.rms_norm(x, p["ln"])
    xi = L.linear(xn, p["rg_in_w"])
    gate = F.gelu(L.linear(xn, p["rg_gate_w"]), approximate="tanh")
    xc = _causal_conv(xi, p["conv_w"], p["conv_b"], cfg.d_conv)
    a, bx = _rglru_gates(p, xc)
    h = torch.zeros((b, xi.shape[-1]), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(s):
        h = a[:, t] * h + bx[:, t]
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype) * gate
    return x + L.linear(y, p["rg_out"], "...c,cd->...d")


def rglru_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 state: Dict) -> Tuple[torch.Tensor, Dict]:
    """state: conv (B, d_conv-1, lw); h (B, lw)."""
    xn = L.rms_norm(x, p["ln"])
    xi = L.linear(xn, p["rg_in_w"])                       # (B, 1, lw)
    gate = F.gelu(L.linear(xn, p["rg_gate_w"]), approximate="tanh")
    hist, xc = _conv_step(p, state, xi)
    a, bx = _rglru_gates(p, xc[:, None, :])
    h = a[:, 0] * state["h"] + bx[:, 0]
    y = h[:, None, :].to(x.dtype) * gate
    out = x + L.linear(y, p["rg_out"], "...c,cd->...d")
    return out, dict(state, conv=hist[:, 1:], h=h)
