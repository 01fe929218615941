"""Wrapper of the CUDA ``kv_decode`` kernel (csrc/kv_decode.cu).

Replaces ``repro/kernels/kv_decode.py:kv_decode``: one-token GQA
attention of q (B, H, D) over a dense packed cache K, V
(B, S, Hkv, ceil(D/32) * bits) int32 words, masked at ``kv_len`` (B,)
(values past S count as S; 0 gives zeros). Output (B, H, D) in q's
dtype. The sequence is split into chunks across blocks (flash-decoding)
and the chunks are merged in order; a block stages its chunk's rows in
shared memory ``tile_rows`` rows at a time. The kernel's body is shared
with ``paged_attention`` (the dense cache is one page per sequence).
"""
from __future__ import annotations

import torch

from repro_torch.core.bitpack import packed_group_words
from repro_torch.core.formats import FLOAT_FORMATS
from repro_torch.kernels.build import (LaunchCount, check, library, require,
                                       sm_count, stream_ptr)

launches = LaunchCount()

BLOCKS_PER_SM = 2
MAX_CHUNK = 512                  # rows per block (bounds the row index)
MAX_HEAD_DIM = 256
STAGE_BYTES = 96 * 1024          # K and V rows a block stages at once
MAX_SHARED = 232448              # shared memory a block may take (sm_90)


def chunk_plan(pairs: int, s: int, sms: int):
    """(chunk, n_chunks): rows per block, a multiple of 32, so that the
    (batch * kv-head, chunk) grid covers the SMs."""
    want = max(1, -(-(BLOCKS_PER_SM * sms) // max(pairs, 1)))
    want = min(want, max(-(-s // 32), 1))
    rows = -(-s // want)
    chunk = min(max(-(-rows // 32), 1) * 32, MAX_CHUNK)
    return chunk, max(-(-s // chunk), 1)


def tile_rows(chunk: int, row_bytes: int) -> int:
    """Rows a block stages at once: the whole chunk when its K and V rows
    (each padded by at most 16 bytes) fit in STAGE_BYTES, else the most
    rows, a multiple of 32 and at least 32, of which a ring of two tiles
    fits."""
    per_row = 2 * (row_bytes + 16)
    if chunk * per_row <= STAGE_BYTES:
        return chunk
    return max(32, STAGE_BYTES // (2 * per_row) // 32 * 32)


def plan(q: torch.Tensor, pairs: int, s: int, group: int, d: int,
         row_bytes: int, op: str):
    """(chunk, n_chunks, tile) of a call; raises on rows the kernel's
    copies do not take and on a block larger than shared memory."""
    if row_bytes % 4:
        raise ValueError(f"{op}: cache rows of {row_bytes} bytes; the "
                         "kernel copies rows in 4-byte units (bf16 rows "
                         "need an even head_dim)")
    chunk, n_chunks = chunk_plan(pairs, s, sm_count(q))
    tile = tile_rows(chunk, row_bytes)
    need = library().rt_attend_smem(group, d, row_bytes, chunk, tile)
    if need > MAX_SHARED:
        raise ValueError(f"{op}: {group} query heads per kv head at "
                         f"head_dim {d} need {need} bytes of shared "
                         f"memory a block, over {MAX_SHARED}")
    return chunk, n_chunks, tile


def scratch(q: torch.Tensor, pairs: int, n_chunks: int, group: int, d: int):
    """The split's f32 scratch, one buffer: per-chunk max, sum (pairs,
    n_chunks, group) and accumulator (pairs, n_chunks, group, d)."""
    parts = pairs * n_chunks * group
    ws = torch.empty(parts * (2 + d), dtype=torch.float32, device=q.device)
    return ws[:parts], ws[parts:2 * parts], ws[2 * parts:]


def kv_decode(q: torch.Tensor, k_packed: torch.Tensor, v_packed: torch.Tensor,
              kv_len: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    require(q, "q", (torch.float32, torch.bfloat16), "kv_decode")
    require(k_packed, "k_packed", (torch.int32,), "kv_decode")
    require(v_packed, "v_packed", (torch.int32,), "kv_decode")
    require(kv_len, "kv_len", (torch.int32,), "kv_decode")
    if bits not in FLOAT_FORMATS:
        raise ValueError(f"kv_decode: no float format with {bits} bits")
    if q.ndim != 3 or k_packed.ndim != 4 or k_packed.shape != v_packed.shape:
        raise ValueError("kv_decode: q (B, H, D), K and V (B, S, Hkv, W)")
    b, h, dim = q.shape
    _, s, hkv, words = k_packed.shape
    if (dim != d or k_packed.shape[0] != b or kv_len.shape != (b,)
            or hkv == 0 or h % hkv or words != packed_group_words(d, bits)
            or d > MAX_HEAD_DIM):
        raise ValueError(
            f"kv_decode: q {tuple(q.shape)}, K {tuple(k_packed.shape)}, "
            f"kv_len {tuple(kv_len.shape)} at {bits} bits and d={d} do not "
            f"fit (head_dim <= {MAX_HEAD_DIM})")
    chunk, n_chunks, tile = plan(q, b * hkv, s, h // hkv, d, words * 4,
                                 "kv_decode")
    out = torch.empty_like(q)
    m_ws, l_ws, acc_ws = scratch(q, b * hkv, n_chunks, h // hkv, d)
    rc = library().rt_kv_decode(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_packed.data_ptr(),
        v_packed.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        m_ws.data_ptr(), l_ws.data_ptr(), acc_ws.data_ptr(), b, h, hkv, s, d,
        words, bits, chunk, n_chunks, tile, stream_ptr(q))
    check(rc, "kv_decode")
    launches.n += 1
    return out
