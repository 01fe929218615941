"""Plain PyTorch versions of the port's CUDA kernels.

Ports of the oracles in ``repro/kernels/ref.py``. They are the CPU path
(``kernels.ops`` sends CPU tensors here) and the programs the CUDA
kernels are held to on the card. Packed words are int32 tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import bitpack
from repro_torch.core.formats import (FLOAT_FORMATS, decode_float, decode_int,
                                      encode_float, f32_to_bits)


def _to_out(x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """f32 -> ``out_dtype``, rounding to nearest even. A NaN becomes the
    bf16 NaN the reference writes (its sign | 0x7FC0); torch's own
    conversion writes other bits, and not the same on host and card."""
    if out_dtype != torch.bfloat16:
        return x.to(out_dtype)
    nan = (((f32_to_bits(x) >> 16) & 0x8000) | 0x7FC0).to(torch.int16)
    return torch.where(torch.isnan(x), nan.view(torch.bfloat16),
                       x.to(torch.bfloat16))


def unpack_ref(packed: torch.Tensor, bits: int, n: int,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Value Extractor + Converter: packed words -> floats (last axis n)."""
    return _to_out(bitpack.unpack_floats(packed, bits, n), out_dtype)


def take_rows_ref(packed: torch.Tensor, indices: torch.Tensor, bits: int,
                  n: int, kind: str = "float", signed: bool = True,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gather rows of packed words, decode only the gathered rows:
    packed (R, n*bits/32) int32, indices (B,) -> (B, n)."""
    rows = packed[indices.long()]
    if kind == "float":
        return _to_out(bitpack.unpack_floats(rows, bits, n), out_dtype)
    return decode_int(bitpack.unpack_groups(rows, bits, n), bits,
                      signed).to(out_dtype)


def pack_ref(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Value Truncator: floats -> packed words along the last axis."""
    return bitpack.pack_groups(encode_float(x.float(), FLOAT_FORMATS[bits]),
                               bits)


def pack_kv_row(row: torch.Tensor, bits: int) -> torch.Tensor:
    """One token's (B, Hkv, D) K or V row as a packed cache stores it:
    packed as one (B, Hkv*D) operand, reshaped to (B, Hkv, words), as the
    reference packs it."""
    b = row.shape[0]
    return pack_ref(row.reshape(b, -1), bits).reshape(b, row.shape[1], -1)


def write_rows(cache: torch.Tensor, row: torch.Tensor,
               kv_len: torch.Tensor) -> None:
    """cache[b, kv_len[b]] = row[b], in place, with the row index clamped
    to S - 1 as ``lax.dynamic_update_slice`` clamps it in the reference:
    padding rows and idle slots write at lengths >= S."""
    pos = kv_len.long().clamp(0, cache.shape[1] - 1)
    batch = torch.arange(cache.shape[0], device=cache.device)
    cache[batch, pos] = row.to(cache.dtype)


def pool_row_index(page: int, table: torch.Tensor,
                   kv_len: torch.Tensor) -> torch.Tensor:
    """The flat pool row (page id * page + offset) that holds position
    ``kv_len[b]`` of sequence b, the position clamped to max_pages *
    page - 1."""
    pos = kv_len.long().clamp(0, table.shape[1] * page - 1)
    ids = table.long().gather(1, (pos // page)[:, None])[:, 0]
    return ids * page + pos % page


def scatter_pool_rows(pool: torch.Tensor, row: torch.Tensor,
                      rows: torch.Tensor) -> None:
    """pool's flat rows ``rows`` = row (B, Hkv, W), in place."""
    pool.view((-1,) + tuple(pool.shape[2:]))[rows] = row.to(pool.dtype)


def append_kv_rows_ref(k_cache: torch.Tensor, v_cache: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       kv_len: torch.Tensor, bits: int,
                       table: Optional[torch.Tensor] = None) -> None:
    """One token's packed K/V append, in place: each (B, Hkv, D) row
    packed by ``pack_kv_row`` and written at ``kv_len[b]`` of the dense
    caches (B, S, Hkv, W) or, through ``table`` (B, max_pages), at its
    row of the pools (P+1, page, Hkv, W). Several idle slots may clamp
    onto one scrap-page row; which of their writes lands is not fixed."""
    k_row, v_row = pack_kv_row(k_new, bits), pack_kv_row(v_new, bits)
    if table is None:
        write_rows(k_cache, k_row, kv_len)
        write_rows(v_cache, v_row, kv_len)
        return
    rows = pool_row_index(k_cache.shape[1], table, kv_len)
    scatter_pool_rows(k_cache, k_row, rows)
    scatter_pool_rows(v_cache, v_row, rows)


def convert_ref(code: torch.Tensor, bits: int) -> torch.Tensor:
    """Value Converter: one narrow-float code lane -> f32 lane."""
    return decode_float(code, FLOAT_FORMATS[bits])


def truncate_ref(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Truncation step of the Value Truncator: f32 lane -> code lane."""
    return encode_float(x.float(), FLOAT_FORMATS[bits])


def packed_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor, bits: int,
                      n: int, transpose: bool = False) -> torch.Tensor:
    """x @ unpack(w) in f32: w_packed (K, n*bits/32), or (n, K*bits/32)
    when ``transpose`` (contraction over the packed axis)."""
    if transpose:
        w = unpack_ref(w_packed, bits, x.shape[-1])              # (N, K)
        return torch.matmul(x.float(), w.t())
    w = unpack_ref(w_packed, bits, n)                            # (K, N)
    return torch.matmul(x.float(), w)


def packed_matmul_batched_ref(x: torch.Tensor, w_packed: torch.Tensor,
                              bits: int, n: int,
                              transpose: bool = False) -> torch.Tensor:
    """Per-expert ``x[e] @ unpack(w[e])`` in f32: x (E, C, K); w_packed
    (E, K, n*bits/32), or (E, n, K*bits/32) when ``transpose``
    (contraction over the packed axis): the MoE expert-bank product."""
    if transpose:
        w = unpack_ref(w_packed, bits, x.shape[-1])              # (E, N, K)
        return torch.einsum("eck,enk->ecn", x.float(), w)
    w = unpack_ref(w_packed, bits, n)                            # (E, K, N)
    return torch.einsum("eck,ekn->ecn", x.float(), w)


def packed_matmul_dw_ref(x: torch.Tensor, g: torch.Tensor,
                         transpose: bool = False,
                         batched: bool = False) -> torch.Tensor:
    """Weight cotangent of the fused matmul from its residuals alone, in
    f32; W is never read. Normal orientation (out = x @ W, W (K, N)):
    dW = xᵀ g, (K, N). Transposed (out = x @ Wᵀ, W (N, K)): dW = gᵀ x,
    (N, K). x's and g's leading dims are summed over; with ``batched``
    the leading axis is the expert axis and is kept: x (E, C, K),
    g (E, C, N). Operands are viewed as 2-D (3-D when batched), so it
    is one matmul."""
    xf, gf = x.float(), g.float()
    if batched:
        a, b = (gf, xf) if transpose else (xf, gf)
        return torch.bmm(a.transpose(1, 2), b)
    xf = xf.reshape(-1, xf.shape[-1])
    gf = gf.reshape(-1, gf.shape[-1])
    a, b = (gf, xf) if transpose else (xf, gf)
    return torch.matmul(a.t(), b)


def _attend_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    """One-token GQA attention of q (B, H, D) over float rows K, V
    (B, S, Hkv, D), masked at ``kv_len`` (B,), in f32."""
    b, h, dim = q.shape
    s, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    qg = q.reshape(b, hkv, group, dim).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) / math.sqrt(dim)
    if kv_len is not None:
        mask = (torch.arange(s, device=q.device)[None, None, None, :]
                < kv_len[:, None, None, None])
        logits = torch.where(mask, logits, -torch.inf)
    # fully masked rows (kv_len == 0) anchor at 0 and emit zeros
    mx = logits.amax(-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    p = torch.exp(logits - mx)
    p = p / p.sum(-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(b, h, dim).to(q.dtype)


def kv_decode_ref(q: torch.Tensor, k_packed: torch.Tensor,
                  v_packed: torch.Tensor, bits: int, d: int,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token attention over a packed KV cache: q (B, H, D),
    K/V (B, S, Hkv, D*bits/32), kv_len (B,) valid lengths."""
    return _attend_ref(q, unpack_ref(k_packed, bits, d),
                       unpack_ref(v_packed, bits, d), kv_len)


def gather_pages_ref(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The per-sequence view of a page pool: pool (P+1, page, Hkv, W),
    table (B, max_pages) page ids -> (B, max_pages*page, Hkv, W), whose
    row ``p`` of sequence ``b`` is pool row (table[b, p // page],
    p % page)."""
    g = pool[table.long()]                       # (B, mp, page, Hkv, W)
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, table: torch.Tensor,
                        kv_len: torch.Tensor, bits: int,
                        d: int) -> torch.Tensor:
    """One-token attention through the page table: q (B, H, D); pools
    (P+1, page, Hkv, D*bits/32) packed words, or (P+1, page, Hkv, D)
    float rows when ``bits`` is 0; table (B, max_pages) int32; kv_len
    (B,). Gathers the pages the table names into the dense view, then
    attends as ``kv_decode_ref`` does. Rows gathered through scrap
    entries lie at or past ``kv_len``, where their weight is exactly 0;
    ``kv_len == 0`` gives zeros."""
    kc = gather_pages_ref(k_pool, table)
    vc = gather_pages_ref(v_pool, table)
    if bits:
        return kv_decode_ref(q, kc, vc, bits, d, kv_len)
    return _attend_ref(q, kc, vc, kv_len)
