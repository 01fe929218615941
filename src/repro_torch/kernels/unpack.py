"""Wrapper of the CUDA ``unpack`` kernel (csrc/unpack.cu).

Replaces ``repro/kernels/unpack.py:unpack``: int32 words (...,
ceil(n/32) * bits) -> Table 3 codes -> float32 or bfloat16 (..., n),
decoded along the last axis. Any rank (the leading dims are rows) and
any n; the reference takes 2-D payloads with n a multiple of 32.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitpack import packed_group_words
from repro_torch.core.formats import FLOAT_FORMATS
from repro_torch.kernels.build import (LaunchCount, check, library, require,
                                       sm_count, stream_ptr)

launches = LaunchCount()

_OUT_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def unpack(packed: torch.Tensor, bits: int, n: int,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    require(packed, "packed", (torch.int32,), "unpack")
    if bits not in FLOAT_FORMATS:
        raise ValueError(f"unpack: no Table 3 float format with {bits} bits")
    if out_dtype not in _OUT_DTYPE:
        raise ValueError(f"unpack: the card decodes to float32 or bfloat16, "
                         f"not {out_dtype}")
    if packed.ndim == 0:
        raise ValueError("unpack: packed needs a last axis of words")
    words = packed.shape[-1]
    if words != packed_group_words(n, bits):
        raise ValueError(f"unpack: {words} words per row do not hold {n} "
                         f"codes of {bits} bits")
    rows = packed.numel() // words if words else 0
    out = torch.empty(packed.shape[:-1] + (n,), dtype=out_dtype,
                      device=packed.device)
    aligned = packed.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    rc = library().rt_unpack(packed.data_ptr(), out.data_ptr(), rows, n, bits,
                             _OUT_DTYPE[out_dtype], int(aligned),
                             sm_count(packed), stream_ptr(packed))
    check(rc, "unpack")
    launches.n += 1
    return out
