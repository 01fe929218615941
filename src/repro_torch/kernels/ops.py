"""Kernel dispatch by tensor device: CUDA tensors go to the hand-written
kernels, CPU tensors to the plain PyTorch versions in ``kernels.ref``.

Port of ``repro/kernels/ops.py`` for the kernels of the serving and
training paths (with ``packed_matmul_dw``, training's dW, which has no
kernel in either package) and the materialized ``unpack``, plus
``convert``/``truncate`` entries for the Value Converter and Truncator
lanes (the reference calls those kernels directly). The op and path names of every ``DispatchRecord``
are the reference's. The reference records once per traced program; the port
runs eagerly, so it keeps each distinct record once (a dict used as an
ordered set). The per-call count is the wrapper's launch counter. A CUDA
tensor never falls back to the plain version: its wrapper launches the
kernel or raises.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import convert as _convert
from repro_torch.kernels import kv_decode as _kv_decode
from repro_torch.kernels import pack as _pack
from repro_torch.kernels import paged_attention as _paged_attention
from repro_torch.kernels import packed_matmul as _packed_matmul
from repro_torch.kernels import packed_matmul_batched as _packed_matmul_batched
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import take as _take
from repro_torch.kernels import unpack as _unpack


class DispatchRecord(NamedTuple):
    """One dispatch (or fallback) decision."""

    op: str                               # packed_matmul | pack | ...
    path: str                             # fused | encode | take | ...
    shape: Tuple[int, ...] = ()           # logical operand shape
    bits: int = 0                         # packed width (0 = unpacked)
    spec: str = ""                        # normalized einsum spec, if any
    reason: str = ""                      # fallbacks: why it fell off


# distinct records in first-seen order; ``.clear()`` starts a new window
DISPATCH_RECORDS: Dict[DispatchRecord, None] = {}
FALLBACK_RECORDS: Dict[DispatchRecord, None] = {}


def record_fallback(op: str, spec: str = "", shape: Tuple[int, ...] = (),
                    bits: int = 0, reason: str = "") -> None:
    """A packed operand leaving the fused path (CPU tensors only)."""
    FALLBACK_RECORDS[DispatchRecord(
        op=op, path="fallback", shape=tuple(int(s) for s in shape),
        bits=int(bits), spec=spec, reason=reason)] = None


def record_dispatch(op: str, path: str, shape: Tuple[int, ...] = (),
                    bits: int = 0) -> None:
    """Keep the record of a dispatch, once per distinct (op, path, shape,
    bits)."""
    DISPATCH_RECORDS[DispatchRecord(op, path, tuple(shape), bits)] = None


def pack(x: torch.Tensor, bits: int) -> torch.Tensor:
    record_dispatch("pack", "encode")
    if x.is_cuda:
        if x.dtype not in (torch.float32, torch.bfloat16):
            x = x.float()
        return _pack.pack(x.contiguous(), bits)
    return _ref.pack_ref(x, bits)


def append_kv_rows(k_cache: torch.Tensor, v_cache: torch.Tensor,
                   k_new: torch.Tensor, v_new: torch.Tensor,
                   kv_len: torch.Tensor, bits: int,
                   table: Optional[torch.Tensor] = None) -> None:
    """One token's K and V rows (B, Hkv, D) packed and written in place at
    row ``kv_len[b]`` of the packed dense caches (B, S, Hkv, W), or
    through the page table (B, max_pages) at their pool rows (P+1, page,
    Hkv, W): the reference's ``kops.pack`` of the flat row and its
    write, one kernel launch on the card."""
    record_dispatch("pack", "encode")
    if k_cache.is_cuda:
        _pack.append_kv_rows(
            k_cache, v_cache, k_new, v_new,
            kv_len.to(torch.int32).contiguous(), bits,
            None if table is None else table.to(torch.int32).contiguous())
        return
    _ref.append_kv_rows_ref(k_cache, v_cache, k_new, v_new, kv_len, bits,
                            table)


def unpack(packed: torch.Tensor, bits: int, n: int,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Materialized decode of packed words (..., ceil(n/32)*bits) to
    (..., n) floats, any rank (the reference's ``ops.unpack`` sends only
    2-D payloads to its kernel)."""
    record_dispatch("unpack", "materialized",
                    shape=tuple(packed.shape[:-1]) + (n,), bits=bits)
    if packed.is_cuda:
        return _unpack.unpack(packed.contiguous(), bits, n, out_dtype)
    return _ref.unpack_ref(packed, bits, n, out_dtype)


def convert(code: torch.Tensor, bits: int) -> torch.Tensor:
    """Code lanes -> f32 lanes (the Value Converter); no record, as in
    the reference."""
    if code.is_cuda:
        return _convert.convert(code.contiguous(), bits)
    return _ref.convert_ref(code, bits)


def truncate(x: torch.Tensor, bits: int) -> torch.Tensor:
    """f32 (or bf16, widened exactly) lanes -> code lanes (the Value
    Truncator); no record, as in the reference."""
    if x.is_cuda:
        return _convert.truncate(x.contiguous(), bits)
    return _ref.truncate_ref(x, bits)


def take_rows(packed: torch.Tensor, indices: torch.Tensor, bits: int, n: int,
              kind: str = "float", signed: bool = True,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Gather rows of a 2-D packed payload and decode only those rows
    (the packed ``embed`` path)."""
    record_dispatch("take_rows", "take",
                    shape=tuple(packed.shape[:-1]) + (n,), bits=bits)
    if packed.is_cuda:
        return _take.take_rows(packed, indices.contiguous(), bits, n,
                               kind=kind, signed=signed, out_dtype=out_dtype)
    return _ref.take_rows_ref(packed, indices, bits, n, kind, signed,
                              out_dtype)


def packed_matmul(x: torch.Tensor, w_packed: torch.Tensor, bits: int, n: int,
                  transpose: bool = False) -> torch.Tensor:
    """Fused unpack + matmul, the packed-weight hot path. On the card the
    output is in x's dtype; the plain version returns float32."""
    record_dispatch("packed_matmul", "fused", shape=tuple(w_packed.shape),
                    bits=bits)
    if x.is_cuda:
        return _packed_matmul.packed_matmul(x.contiguous(), w_packed, bits,
                                            n, transpose=transpose)
    return _ref.packed_matmul_ref(x, w_packed, bits, n, transpose)


def packed_matmul_batched(x: torch.Tensor, w_packed: torch.Tensor, bits: int,
                          n: int, transpose: bool = False) -> torch.Tensor:
    """Fused unpack + matmul over a leading expert axis (the MoE
    expert-bank hot path): x (E, C, K), w_packed (E, K, n*bits/32) (or
    (E, n, K*bits/32) when ``transpose``) -> (E, C, n). On the card the
    output is in x's dtype; the plain version returns float32."""
    record_dispatch("packed_matmul_batched", "fused_batched",
                    shape=tuple(w_packed.shape), bits=bits)
    if x.is_cuda:
        return _packed_matmul_batched.packed_matmul_batched(
            x.contiguous(), w_packed, bits, n, transpose=transpose)
    return _ref.packed_matmul_batched_ref(x, w_packed, bits, n, transpose)


def packed_matmul_dw(x: torch.Tensor, g: torch.Tensor,
                     transpose: bool = False,
                     batched: bool = False) -> torch.Tensor:
    """Weight cotangent of the fused matmul, f32: xᵀ g (gᵀ x for the
    transposed orientation; per expert with ``batched``), from the
    residuals alone, never reading or decoding W. The reference has no
    Pallas kernel for it (a plain contraction, ``kernels/ops.py:186``),
    and neither does the port: one ``torch.matmul`` on the operands
    viewed as 2-D. On the card, bf16 x and g multiply in TF32, which
    holds bf16 exactly, so only the f32 summation order differs."""
    if x.is_cuda and x.dtype == g.dtype == torch.bfloat16:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return _ref.packed_matmul_dw_ref(x, g, transpose, batched)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return _ref.packed_matmul_dw_ref(x, g, transpose, batched)


def kv_decode(q: torch.Tensor, k_packed: torch.Tensor, v_packed: torch.Tensor,
              kv_len: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    record_dispatch("kv_decode", "kv_decode", shape=tuple(k_packed.shape),
                    bits=bits)
    if q.is_cuda:
        return _kv_decode.kv_decode(q.contiguous(), k_packed, v_packed,
                                    kv_len.to(torch.int32).contiguous(),
                                    bits, d)
    return _ref.kv_decode_ref(q, k_packed, v_packed, bits, d, kv_len)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, table: torch.Tensor,
                    kv_len: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """Attend one token straight through the page table (the paged
    serving hot path): pools (P+1, page, Hkv, W) packed words, or rows
    when ``bits`` is 0; table (B, max_pages) int32 page ids. Only the
    pages the table names are read."""
    record_dispatch("paged_attention", "fused_paged",
                    shape=tuple(k_pool.shape), bits=bits)
    if q.is_cuda:
        return _paged_attention.paged_attention(
            q.contiguous(), k_pool, v_pool, table.to(torch.int32).contiguous(),
            kv_len.to(torch.int32).contiguous(), bits, d)
    return _ref.paged_attention_ref(q, k_pool, v_pool, table, kv_len, bits,
                                    d)


_KERNELS = {"packed_matmul": _packed_matmul.launches,
            # of those, the transposed orientation's (a tied head)
            "packed_matmul_transposed": _packed_matmul.transposed_launches,
            "pack": _pack.launches,
            "kv_decode": _kv_decode.launches, "take_rows": _take.launches,
            "packed_matmul_batched": _packed_matmul_batched.launches,
            "paged_attention": _paged_attention.launches,
            "unpack": _unpack.launches,
            "convert": _convert.convert_launches,
            "truncate": _convert.truncate_launches}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {name: count.n for name, count in _KERNELS.items()}


def reset_launch_counts() -> None:
    for count in _KERNELS.values():
        count.n = 0
