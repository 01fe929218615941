"""Plain PyTorch versions of the port's four CUDA kernels.

Ports of the oracles in ``repro/kernels/ref.py``. They are the CPU path
(``kernels.ops`` sends CPU tensors here) and the programs the CUDA
kernels are held to on the card. Packed words are int32 tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import bitpack
from repro_torch.core.formats import FLOAT_FORMATS, decode_float, decode_int, encode_float


def unpack_ref(packed: torch.Tensor, bits: int, n: int,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Value Extractor + Converter: packed words -> floats (last axis n)."""
    codes = bitpack.unpack_groups(packed, bits, n)
    return decode_float(codes, FLOAT_FORMATS[bits]).to(out_dtype)


def take_rows_ref(packed: torch.Tensor, indices: torch.Tensor, bits: int,
                  n: int, kind: str = "float", signed: bool = True,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gather rows of packed words, decode only the gathered rows:
    packed (R, n*bits/32) int32, indices (B,) -> (B, n)."""
    rows = packed[indices.long()]
    codes = bitpack.unpack_groups(rows, bits, n)
    if kind == "float":
        out = decode_float(codes, FLOAT_FORMATS[bits])
    else:
        out = decode_int(codes, bits, signed)
    return out.to(out_dtype)


def pack_ref(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Value Truncator: floats -> packed words along the last axis."""
    return bitpack.pack_groups(encode_float(x.float(), FLOAT_FORMATS[bits]),
                               bits)


def packed_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor, bits: int,
                      n: int, transpose: bool = False) -> torch.Tensor:
    """x @ unpack(w) in f32: w_packed (K, n*bits/32), or (n, K*bits/32)
    when ``transpose`` (contraction over the packed axis)."""
    if transpose:
        w = unpack_ref(w_packed, bits, x.shape[-1])              # (N, K)
        return torch.matmul(x.float(), w.t())
    w = unpack_ref(w_packed, bits, n)                            # (K, N)
    return torch.matmul(x.float(), w)


def kv_decode_ref(q: torch.Tensor, k_packed: torch.Tensor,
                  v_packed: torch.Tensor, bits: int, d: int,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-token attention over a packed KV cache: q (B, H, D),
    K/V (B, S, Hkv, D*bits/32), kv_len (B,) valid lengths."""
    b, h, dim = q.shape
    s, hkv = k_packed.shape[1], k_packed.shape[2]
    group = h // hkv
    k = unpack_ref(k_packed, bits, d)                            # (B, S, Hkv, D)
    v = unpack_ref(v_packed, bits, d)
    qg = q.reshape(b, hkv, group, dim).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k) / math.sqrt(dim)
    if kv_len is not None:
        mask = (torch.arange(s, device=q.device)[None, None, None, :]
                < kv_len[:, None, None, None])
        logits = torch.where(mask, logits, -torch.inf)
    # fully masked rows (kv_len == 0) anchor at 0 and emit zeros
    mx = logits.amax(-1, keepdim=True)
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    p = torch.exp(logits - mx)
    p = p / p.sum(-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", p, v)
    return out.reshape(b, h, dim).to(q.dtype)
