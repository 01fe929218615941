"""Attention over a sequence (prefill and the loss), cached single-token
decode attention and the KV append, dense and paged.

Port of ``repro.models.attention``. ``flash_attention`` is the
reference's online-softmax double loop (q chunks x kv chunks) in plain
PyTorch, as the reference computes it in jnp outside any kernel: bf16
operands, f32 logits and sums, causal, local-window and full masks, GQA
folded onto the kv head. A packed cache is
an int32 word tensor (B, S, Hkv, ceil(D/32) * bits): the append packs
the new K and V rows and stores their words in one
``kernels.ops.append_kv_rows`` call, and attention reads the words
through ``kernels.ops.kv_decode``, so the cache is never decoded to
device memory. A paged cache is one layer's page pool (P+1, page, Hkv,
W) shared by all sequences and a page table (B, max_pages): the append
writes the row straight to its physical page and attention reads the
pool through the table (``kernels.ops.paged_attention``).

Unlike the reference, the appends write the cache in place (the caller's
state is updated, not copied): the cache is the largest tensor of the
decode state and the engine never needs the old one.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

NEG_INF = -1e30


def _chunk_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                window: int) -> torch.Tensor:
    """(Sq_blk, Sk_blk) validity mask. The reference's ``prefix`` (a
    bidirectional leading segment) is left out: no caller passes it."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def _divisor_chunk(target: int, s: int) -> int:
    """The largest divisor of ``s`` that is at most ``target``."""
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    q_chunk: int = 1024, kv_chunk: int = 1024
                    ) -> torch.Tensor:
    """q (B, Sq, H, D), k and v (B, Sk, Hkv, D) -> (B, Sq, H, D) in q's
    dtype. Logits and the running sums are f32 products of the operands
    in their own dtype (a bf16 product is exact in f32); the weights
    meet v rounded to v's dtype, as the reference's do."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(d)
    qc, kc = _divisor_chunk(q_chunk, sq), _divisor_chunk(kv_chunk, sk)
    # (B, Hkv, G, Sq, D) queries; (B, Hkv, Sk, D) keys and values
    qs = q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).float()
    ks = k.permute(0, 2, 1, 3).float()
    vs = v.permute(0, 2, 1, 3)
    pos = torch.arange(max(sq, sk), device=q.device)
    out = []
    for q0 in range(0, sq, qc):
        qb = qs[:, :, :, q0:q0 + qc]
        acc = q.new_zeros((b, hkv, g, qc, d), dtype=torch.float32)
        m_run = torch.full((b, hkv, g, qc, 1), NEG_INF, dtype=torch.float32,
                           device=q.device)
        l_run = torch.zeros_like(m_run)
        for k0 in range(0, sk, kc):
            logits = torch.einsum("bkgqd,bkcd->bkgqc", qb,
                                  ks[:, :, k0:k0 + kc]) * scale
            mask = _chunk_mask(pos[q0:q0 + qc], pos[k0:k0 + kc], causal,
                               window)
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m_run, logits.amax(-1, keepdim=True))
            r = torch.exp(m_run - m_new)
            p = torch.exp(logits - m_new)
            vb = vs[:, :, k0:k0 + kc]
            acc = acc * r + torch.einsum("bkgqc,bkcd->bkgqd",
                                         p.to(vb.dtype).float(), vb.float())
            l_run = l_run * r + p.sum(-1, keepdim=True)
            m_run = m_new
        out.append(acc / l_run.clamp(min=1e-30))
    o = torch.cat(out, dim=3)                          # (B, Hkv, G, Sq, D)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, kv_len: torch.Tensor,
                     kv_bits: Optional[int] = None) -> torch.Tensor:
    """Score one token (q (B, H, D)) against the cache, masked at
    ``kv_len`` (B,). A packed cache goes to the ``kv_decode`` kernel."""
    if kv_bits:
        return kops.kv_decode(q, k_cache, v_cache, kv_len, kv_bits,
                              q.shape[-1])
    b, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg,
                          k_cache.float()) / math.sqrt(d)
    mask = (torch.arange(s, device=q.device)[None, None, None, :]
            < kv_len[:, None, None, None])
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)


def update_kv_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor,
                    kv_len: torch.Tensor, kv_bits: Optional[int] = None):
    """Write one token's K/V (B, Hkv, D) at row ``kv_len[b]`` of each
    sequence, in place, the row clamped to S - 1 as the reference's
    ``dynamic_update_slice`` clamps it. A packed cache takes the row
    packed as one (B, Hkv*D) operand, reshaped to (B, Hkv, words), as the
    reference does: one ``kernels.ops.append_kv_rows`` call."""
    if kv_bits:
        kops.append_kv_rows(k_cache, v_cache, k_new, v_new, kv_len, kv_bits)
    else:
        kref.write_rows(k_cache, k_new, kv_len)
        kref.write_rows(v_cache, v_new, kv_len)
    return k_cache, v_cache


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, table: torch.Tensor,
                           kv_len: torch.Tensor,
                           kv_bits: Optional[int] = None) -> torch.Tensor:
    """Score one token (q (B, H, D)) straight through the page table:
    only the pages the table names are read."""
    return kops.paged_attention(q, k_pool, v_pool, table, kv_len,
                                kv_bits or 0, q.shape[-1])


def append_kv_pool_row(k_pool: torch.Tensor, v_pool: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       table: torch.Tensor, kv_len: torch.Tensor,
                       kv_bits: Optional[int] = None):
    """Write one token's (B, Hkv, D) K/V row straight to its physical
    page, in place. The row packs as ``update_kv_cache`` packs it, so
    dense and paged caches hold identical words. Lengths past the table
    clamp onto its last entry (the scrap page 0 for an idle slot)."""
    if kv_bits:
        kops.append_kv_rows(k_pool, v_pool, k_new, v_new, kv_len, kv_bits,
                            table)
    else:
        rows = kref.pool_row_index(k_pool.shape[1], table, kv_len)
        kref.scatter_pool_rows(k_pool, k_new, rows)
        kref.scatter_pool_rows(v_pool, v_new, rows)
    return k_pool, v_pool
