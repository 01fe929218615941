"""Kernel dispatch by tensor device: CUDA tensors go to the hand-written
kernels, CPU tensors to the plain PyTorch versions in ``kernels.ref``.

Port of ``repro/kernels/ops.py`` for the four kernels of the serving
path. The op and path names of every ``DispatchRecord`` are the
reference's. The reference records once per traced program; the port
runs eagerly, so it keeps each distinct record once (a dict used as an
ordered set). The per-call count is the wrapper's launch counter. A CUDA
tensor never falls back to the plain version: its wrapper launches the
kernel or raises.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import kv_decode as _kv_decode
from repro_torch.kernels import pack as _pack
from repro_torch.kernels import packed_matmul as _packed_matmul
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import take as _take


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
        return _pack.pack(x.float().contiguous(), bits)
    return _ref.pack_ref(x, bits)


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


def kv_decode(q: torch.Tensor, k_packed: torch.Tensor, v_packed: torch.Tensor,
              kv_len: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    record_dispatch("kv_decode", "kv_decode", shape=tuple(k_packed.shape),
                    bits=bits)
    if q.is_cuda:
        return _kv_decode.kv_decode(q.contiguous(), k_packed, v_packed,
                                    kv_len.to(torch.int32).contiguous(),
                                    bits, d)
    return _ref.kv_decode_ref(q, k_packed, v_packed, bits, d, kv_len)


_KERNELS = {"packed_matmul": _packed_matmul, "pack": _pack,
            "kv_decode": _kv_decode, "take_rows": _take}


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {name: mod.launches.n for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches.n = 0
