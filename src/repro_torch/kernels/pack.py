"""Wrapper of the CUDA ``pack`` kernel (csrc/pack.cu).

Replaces ``repro/kernels/pack.py:pack``. float32 (..., N) -> Table 3
codes -> int32 words (..., ceil(N/32) * bits), packed along the last
axis; N need not be a multiple of 32.
"""
from __future__ import annotations

import torch

from repro_torch.core.bitpack import packed_group_words
from repro_torch.core.formats import FLOAT_FORMATS
from repro_torch.kernels.build import (LaunchCount, check, library, require,
                                       stream_ptr)

launches = LaunchCount()


def pack(x: torch.Tensor, bits: int) -> torch.Tensor:
    require(x, "x", (torch.float32,), "pack")
    if bits not in FLOAT_FORMATS:
        raise ValueError(f"pack: no Table 3 float format with {bits} bits")
    if x.ndim == 0:
        raise ValueError("pack: x needs a last axis to pack along")
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    out = torch.empty(x.shape[:-1] + (packed_group_words(n, bits),),
                      dtype=torch.int32, device=x.device)
    rc = library().rt_pack(x.data_ptr(), out.data_ptr(), rows, n, bits,
                           stream_ptr(x))
    check(rc, "pack")
    launches.n += 1
    return out
