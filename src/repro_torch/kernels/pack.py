"""Wrappers of the CUDA ``pack`` kernels (csrc/pack.cu).

``pack`` replaces ``repro/kernels/pack.py:pack``: float32 or bfloat16
(..., N) -> Table 3 codes -> int32 words (..., ceil(N/32) * bits),
packed along the last axis; N need not be a multiple of 32.

``append_kv_rows`` is the decode tick's KV append built on the same
encode: one layer's new K and V rows packed as the flat (B, Hkv * D)
operand the reference packs (``repro/models/attention.py``) and stored
at the cache rows the append names, dense or paged, in one launch. Both
count as launches of ``pack``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.bitpack import packed_group_words
from repro_torch.core.formats import FLOAT_FORMATS
from repro_torch.kernels.build import (LaunchCount, check, library, require,
                                       stream_ptr)

launches = LaunchCount()

_IN_DTYPES = (torch.float32, torch.bfloat16)


def _check_bits(bits: int, op: str) -> None:
    if bits not in FLOAT_FORMATS:
        raise ValueError(f"{op}: no Table 3 float format with {bits} bits")


def pack(x: torch.Tensor, bits: int) -> torch.Tensor:
    require(x, "x", _IN_DTYPES, "pack")
    _check_bits(bits, "pack")
    if x.ndim == 0:
        raise ValueError("pack: x needs a last axis to pack along")
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    out = torch.empty(x.shape[:-1] + (packed_group_words(n, bits),),
                      dtype=torch.int32, device=x.device)
    rc = library().rt_pack(x.data_ptr(), out.data_ptr(), rows, n, bits,
                           int(x.dtype == torch.bfloat16), stream_ptr(x))
    check(rc, "pack")
    launches.n += 1
    return out


def append_kv_rows(k_cache: torch.Tensor, v_cache: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   kv_len: torch.Tensor, bits: int,
                   table: Optional[torch.Tensor] = None) -> None:
    """Pack k_new, v_new (B, Hkv, D), float32 or bfloat16 with any
    strides, and store them in place at one row of each sequence: of the
    dense caches (B, S, Hkv, W) at clamp(kv_len[b], 0, S - 1), or, with a
    page table (B, max_pages), of the pools (P + 1, page, Hkv, W) at
    page ``table[b, pos // page]``, row ``pos % page``, where pos =
    clamp(kv_len[b], 0, max_pages * page - 1). kv_len and the table are
    read on the card."""
    op = "append_kv_rows"
    _check_bits(bits, op)
    for t, name in ((k_cache, "k_cache"), (v_cache, "v_cache"),
                    (kv_len, "kv_len")):
        require(t, name, (torch.int32,), op)
    for t, name in ((k_new, "k_new"), (v_new, "v_new")):
        if not t.is_cuda or t.device != k_cache.device:
            raise ValueError(f"{op}: {name} must be a CUDA tensor on "
                             f"{k_cache.device}")
        if t.dtype not in _IN_DTYPES or t.ndim != 3:
            raise ValueError(f"{op}: {name} must be (B, Hkv, D) float32 or "
                             f"bfloat16, got {tuple(t.shape)} {t.dtype}")
    if k_new.shape != v_new.shape or k_new.dtype != v_new.dtype:
        raise ValueError(f"{op}: k_new and v_new differ in shape or dtype")
    b, hkv, d = k_new.shape
    w = packed_group_words(d, bits)
    if k_cache.shape != v_cache.shape or k_cache.ndim != 4 \
            or tuple(k_cache.shape[2:]) != (hkv, w):
        raise ValueError(f"{op}: caches {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)} are not (rows, rows, {hkv}, "
                         f"{w}) words")
    if d % 32 and hkv > 1:
        # the reference packs the flat (Hkv * D) row: groups of 32 codes
        # would straddle heads
        raise ValueError(f"{op}: head_dim {d} is not a multiple of 32")
    if w > 1024:
        raise ValueError(f"{op}: {w} words a head, at most 1024")
    if kv_len.shape != (b,):
        raise ValueError(f"{op}: kv_len {tuple(kv_len.shape)} is not ({b},)")
    if table is None:
        if k_cache.shape[0] != b:
            raise ValueError(f"{op}: a dense cache holds {k_cache.shape[0]} "
                             f"sequences, not {b}")
        seq, mp, pages, table_ptr = k_cache.shape[1], 0, 0, None
    else:
        require(table, "table", (torch.int32,), op)
        if table.ndim != 2 or table.shape[0] != b or table.shape[1] == 0:
            raise ValueError(f"{op}: table {tuple(table.shape)} is not "
                             f"({b}, max_pages)")
        seq, mp, pages = k_cache.shape[1], table.shape[1], k_cache.shape[0]
        table_ptr = table.data_ptr()
    ks, vs = k_new.stride(), v_new.stride()
    rc = library().rt_append_kv(
        k_new.data_ptr(), *ks, v_new.data_ptr(), *vs,
        int(k_new.dtype == torch.bfloat16), k_cache.data_ptr(),
        v_cache.data_ptr(), kv_len.data_ptr(), table_ptr, b, hkv, d, w, seq,
        mp, pages, bits, stream_ptr(k_cache))
    check(rc, op)
    launches.n += 1
