"""Wrapper of the CUDA ``take_rows`` kernel (csrc/take.cu).

Replaces ``repro/kernels/take.py:take_rows``: gather rows of a 2-D
packed table by index (any order, duplicates allowed) and decode only
those rows, float kind or int kind (signed or unsigned). Indices outside
the table are clamped into it by the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import FLOAT_FORMATS
from repro_torch.kernels.build import (LaunchCount, check, library, require,
                                       stream_ptr)

launches = LaunchCount()

_OUT_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}


def take_rows(packed: torch.Tensor, indices: torch.Tensor, bits: int, n: int,
              kind: str = "float", signed: bool = True,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    require(packed, "packed", (torch.int32,), "take_rows")
    require(indices, "indices", (torch.int32, torch.int64), "take_rows")
    if packed.ndim != 2 or indices.ndim != 1:
        raise ValueError("take_rows: packed must be 2-D and indices 1-D")
    if kind not in ("float", "int"):
        raise ValueError(f"take_rows: unknown kind {kind!r}")
    if kind == "float" and (bits not in FLOAT_FORMATS
                            or out_dtype not in (torch.float32,
                                                 torch.bfloat16)):
        raise ValueError(f"take_rows: float kind needs a Table 3 width and "
                         f"a float32/bfloat16 output, got {bits}, {out_dtype}")
    if kind == "int" and (bits % 4 or not 4 <= bits <= 32
                          or out_dtype not in (torch.float32, torch.int32)):
        raise ValueError(f"take_rows: int kind needs a width in 4..32 step 4 "
                         f"and a float32/int32 output, got {bits}, {out_dtype}")
    words = packed.shape[1]
    if words != -(-n // 32) * bits:
        raise ValueError(f"take_rows: {words} words per row do not hold "
                         f"{n} codes of {bits} bits")
    if packed.shape[0] == 0:
        raise ValueError("take_rows: empty table")
    out = torch.empty((indices.shape[0], n), dtype=out_dtype,
                      device=packed.device)
    rc = library().rt_take_rows(
        packed.data_ptr(), indices.data_ptr(),
        int(indices.dtype == torch.int64), out.data_ptr(),
        _OUT_KIND[out_dtype], packed.shape[0], words, indices.shape[0], n,
        bits, int(kind == "int"), int(signed), stream_ptr(packed))
    check(rc, "take_rows")
    launches.n += 1
    return out
