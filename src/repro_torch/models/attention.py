"""Cached single-token decode attention and the KV append.

Port of the decode half of ``repro.models.attention``. A packed cache is
an int32 word tensor (B, S, Hkv, ceil(D/32) * bits): the append packs
each new row through ``kernels.ops.pack`` and attention reads the words
through ``kernels.ops.kv_decode``, so the cache is never decoded to
device memory. The prefill/training attention comes with ROADMAP A13.

Unlike the reference, the append writes the cache in place (the caller's
state is updated, not copied): the cache is the largest tensor of the
decode state and the engine never needs the old one.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops as kops

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
    sequence, in place. A packed cache takes the row packed as one
    (B, Hkv*D) operand, reshaped to (B, Hkv, words), as the reference
    does."""
    if kv_bits:
        b = k_new.shape[0]
        k_new = kops.pack(k_new.reshape(b, -1).float(), kv_bits).reshape(
            b, k_new.shape[1], -1)
        v_new = kops.pack(v_new.reshape(b, -1).float(), kv_bits).reshape(
            b, v_new.shape[1], -1)
    _write_rows(k_cache, k_new, kv_len)
    _write_rows(v_cache, v_new, kv_len)
    return k_cache, v_cache


def _write_rows(cache: torch.Tensor, row: torch.Tensor,
                kv_len: torch.Tensor) -> None:
    """cache[b, kv_len[b]] = row[b], with the row index clamped to S - 1
    as ``lax.dynamic_update_slice`` clamps it in the reference: padding
    rows and idle slots write at lengths >= S."""
    pos = kv_len.long().clamp(0, cache.shape[1] - 1)
    batch = torch.arange(cache.shape[0], device=cache.device)
    cache[batch, pos] = row.to(cache.dtype)
