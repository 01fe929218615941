"""Wrappers of the CUDA ``convert`` and ``truncate`` kernels
(csrc/convert.cu).

Replace ``repro/kernels/convert.py:convert`` / ``truncate``, the Value
Converter and Truncator as elementwise lanes: int32 codes -> float32
(``decode_float``), and float32 or bfloat16 -> int32 codes
(``encode_float``). Any shape; the reference takes 2-D lanes. Each has
its own launch counter.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import FLOAT_FORMATS
from repro_torch.kernels.build import (LaunchCount, check, library, require,
                                       stream_ptr)

convert_launches = LaunchCount()
truncate_launches = LaunchCount()

_IN_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def _check_bits(bits: int, op: str) -> None:
    if bits not in FLOAT_FORMATS:
        raise ValueError(f"{op}: no Table 3 float format with {bits} bits")


def convert(code: torch.Tensor, bits: int) -> torch.Tensor:
    require(code, "code", (torch.int32,), "convert")
    _check_bits(bits, "convert")
    out = torch.empty(code.shape, dtype=torch.float32, device=code.device)
    rc = library().rt_convert(code.data_ptr(), out.data_ptr(), code.numel(),
                              bits, stream_ptr(code))
    check(rc, "convert")
    convert_launches.n += 1
    return out


def truncate(x: torch.Tensor, bits: int) -> torch.Tensor:
    require(x, "x", tuple(_IN_DTYPE), "truncate")
    _check_bits(bits, "truncate")
    out = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    rc = library().rt_truncate(x.data_ptr(), out.data_ptr(), x.numel(), bits,
                               _IN_DTYPE[x.dtype], stream_ptr(x))
    check(rc, "truncate")
    truncate_launches.n += 1
    return out
