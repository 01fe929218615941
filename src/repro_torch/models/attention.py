"""Cached single-token decode attention and the KV append, dense and
paged.

Port of the decode half of ``repro.models.attention``. A packed cache is
an int32 word tensor (B, S, Hkv, ceil(D/32) * bits): the append packs
the new K and V rows and stores their words in one
``kernels.ops.append_kv_rows`` call, and attention reads the words
through ``kernels.ops.kv_decode``, so the cache is never decoded to
device memory. A paged cache is one layer's page pool (P+1, page, Hkv,
W) shared by all sequences and a page table (B, max_pages): the append
writes the row straight to its physical page and attention reads the
pool through the table (``kernels.ops.paged_attention``). The
prefill/training attention comes with ROADMAP A13.

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
