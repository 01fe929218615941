"""Wrapper of the CUDA ``paged_attention`` kernel (csrc/kv_decode.cu).

Replaces ``repro/kernels/paged_attention.py:paged_attention``: one-token
GQA attention of q (B, H, D) through the page table ``table``
(B, max_pages) int32 over the pools K, V (P+1, page, Hkv, W): int32
words of ``bits``-wide codes, or bf16/f32 rows (W = D) when ``bits`` is
0. Positions at or past ``kv_len`` (B,) are masked (values past
max_pages * page count as that; 0 gives zeros). Output (B, H, D) in q's
dtype. The kernel is ``kv_decode``'s body with the row address looked up
through the table; the split over positions is ``kv_decode``'s
``chunk_plan`` and ``tile_rows`` at S = max_pages * page, so a paged
call gives the bits of a dense call over the same rows. bf16 rows need
an even head_dim (the kernel copies rows in 4-byte units).
"""
from __future__ import annotations

import torch

from repro_torch.core.bitpack import packed_group_words
from repro_torch.core.formats import FLOAT_FORMATS
from repro_torch.kernels.build import (LaunchCount, check, library, require,
                                       stream_ptr)
from repro_torch.kernels.kv_decode import MAX_HEAD_DIM, plan, scratch

launches = LaunchCount()

_KV_KIND = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, table: torch.Tensor,
                    kv_len: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    op = "paged_attention"
    require(q, "q", (torch.float32, torch.bfloat16), op)
    rows = (torch.int32,) if bits else (torch.float32, torch.bfloat16)
    require(k_pool, "k_pool", rows, op)
    require(v_pool, "v_pool", (k_pool.dtype,), op)
    require(table, "table", (torch.int32,), op)
    require(kv_len, "kv_len", (torch.int32,), op)
    if bits and bits not in FLOAT_FORMATS:
        raise ValueError(f"{op}: no float format with {bits} bits")
    if (q.ndim != 3 or k_pool.ndim != 4 or k_pool.shape != v_pool.shape
            or table.ndim != 2):
        raise ValueError(f"{op}: q (B, H, D), pools (P+1, page, Hkv, W), "
                         "table (B, max_pages)")
    b, h, dim = q.shape
    pool_pages, page, hkv, words = k_pool.shape
    max_pages = table.shape[1]
    if (dim != d or table.shape[0] != b or kv_len.shape != (b,)
            or hkv == 0 or h % hkv or pool_pages == 0 or page == 0
            or words != (packed_group_words(d, bits) if bits else d)
            or d > MAX_HEAD_DIM):
        raise ValueError(
            f"{op}: q {tuple(q.shape)}, pools {tuple(k_pool.shape)}, table "
            f"{tuple(table.shape)}, kv_len {tuple(kv_len.shape)} at {bits} "
            f"bits and d={d} do not fit (head_dim <= {MAX_HEAD_DIM})")
    chunk, n_chunks, tile = plan(q, b * hkv, max_pages * page, h // hkv, d,
                                 words * k_pool.element_size(), op)
    out = torch.empty_like(q)
    m_ws, l_ws, acc_ws = scratch(q, b * hkv, n_chunks, h // hkv, d)
    rc = library().rt_paged_attention(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_pool.data_ptr(),
        v_pool.data_ptr(), _KV_KIND[k_pool.dtype], table.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), m_ws.data_ptr(), l_ws.data_ptr(),
        acc_ws.data_ptr(), b, h, hkv, page, max_pages, pool_pages, d, words,
        bits, chunk, n_chunks, tile, stream_ptr(q))
    check(rc, op)
    launches.n += 1
    return out
