"""Group-of-32 packing of narrow codes into 32-bit words.

Port of the group layout of ``repro.core.bitpack``: 32 consecutive codes
of ``width`` bits occupy exactly ``width`` words, little-endian within
the group, and a code may straddle two words. A tensor packs along its
last axis to ``ceil(n/32) * width`` words; pad codes are zero. Words are
int32 tensors (see ``repro_torch.core.formats``). Stream packing
(``pack_stream``) is not ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import SLICE_BITS, _srl

GROUP = 32


def _check_width(width: int) -> None:
    if not (1 <= width <= 32) or width % SLICE_BITS != 0:
        raise ValueError(
            f"width must be a multiple of {SLICE_BITS} in [4, 32], got {width}")


def _width_mask(width: int) -> int:
    return -1 if width == 32 else (1 << width) - 1


def packed_group_words(n: int, width: int) -> int:
    """Packed last-dim length for ``n`` codes (padded to a full group)."""
    _check_width(width)
    return -(-n // GROUP) * width


def pack_groups(codes: torch.Tensor, width: int) -> torch.Tensor:
    """Pack codes (..., N) -> words (..., ceil(N/32)*width)."""
    _check_width(width)
    codes = codes.to(torch.int32) & _width_mask(width)
    n = codes.shape[-1]
    groups = -(-n // GROUP)
    pad = groups * GROUP - n
    if pad:
        codes = torch.nn.functional.pad(codes, (0, pad))
    g = codes.reshape(codes.shape[:-1] + (groups, GROUP))
    words = []
    for w in range(width):
        acc = None
        for j in range(GROUP):
            s = j * width
            if s // 32 == w:                       # low part lands here
                part = g[..., j] << (s % 32)
            elif s // 32 == w - 1 and s % 32 + width > 32:  # spill part
                part = _srl(g[..., j], 32 - s % 32)
            else:
                continue
            acc = part if acc is None else acc | part
        words.append(acc)
    out = torch.stack(words, dim=-1)               # (..., groups, width)
    return out.reshape(out.shape[:-2] + (groups * width,))


def unpack_groups(words: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_groups`: words (..., G*width) -> codes (..., n)."""
    _check_width(width)
    groups = words.shape[-1] // width
    g = words.to(torch.int32).reshape(words.shape[:-1] + (groups, width))
    cols = []
    for j in range(GROUP):
        s = j * width
        w0, off = s // 32, s % 32
        lo = _srl(g[..., w0], off)
        if off + width > 32:
            lo = lo | (g[..., w0 + 1] << (32 - off))
        cols.append(lo & _width_mask(width))
    out = torch.stack(cols, dim=-1)                # (..., groups, 32)
    out = out.reshape(out.shape[:-2] + (groups * GROUP,))
    return out[..., :n]
