"""Wrapper of the CUDA ``kv_decode`` kernel (csrc/kv_decode.cu).

Replaces ``repro/kernels/kv_decode.py:kv_decode``: one-token GQA
attention of q (B, H, D) over a dense packed cache K, V
(B, S, Hkv, ceil(D/32) * bits) int32 words, masked at ``kv_len`` (B,)
(values past S count as S; 0 gives zeros). Output (B, H, D) in q's
dtype. The sequence is split into chunks across blocks (flash-decoding)
and the chunks are merged in order.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitpack import packed_group_words
from repro_torch.core.formats import FLOAT_FORMATS
from repro_torch.kernels.build import (LaunchCount, check, library, require,
                                       sm_count, stream_ptr)

launches = LaunchCount()

BLOCKS_PER_SM = 2
MAX_CHUNK = 512                  # rows per block (bounds shared memory)
MAX_HEAD_DIM = 256


def chunk_plan(pairs: int, s: int, sms: int):
    """(chunk, n_chunks): rows per block, a multiple of 32, so that the
    (batch * kv-head, chunk) grid covers the SMs."""
    want = max(1, -(-(BLOCKS_PER_SM * sms) // max(pairs, 1)))
    want = min(want, max(-(-s // 32), 1))
    rows = -(-s // want)
    chunk = min(max(-(-rows // 32), 1) * 32, MAX_CHUNK)
    return chunk, max(-(-s // chunk), 1)


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
    g = h // hkv
    chunk, n_chunks = chunk_plan(b * hkv, s, sm_count(q))
    out = torch.empty_like(q)
    # one scratch buffer: per-chunk max, sum and accumulator
    parts = b * hkv * n_chunks * g
    ws = torch.empty(parts * (2 + d), dtype=torch.float32, device=q.device)
    m_ws, l_ws, acc_ws = ws[:parts], ws[parts:2 * parts], ws[2 * parts:]
    rc = library().rt_kv_decode(
        q.data_ptr(), int(q.dtype == torch.bfloat16), k_packed.data_ptr(),
        v_packed.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        m_ws.data_ptr(), l_ws.data_ptr(), acc_ws.data_ptr(), b, h, hkv, s, d,
        words, bits, chunk, n_chunks, stream_ptr(q))
    check(rc, "kv_decode")
    launches.n += 1
    return out
