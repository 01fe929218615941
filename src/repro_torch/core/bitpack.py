"""Packing of narrow codes into 32-bit words.

Port of ``repro.core.bitpack``, both layouts. Words are int32 tensors
(see ``repro_torch.core.formats``) on the codes' device.

* **Stream** (``pack_stream`` / ``unpack_stream``): the storage of the
  paper's register file. Codes of ``width`` bits lie back to back, code
  ``i`` at stream bits ``[i*width, (i+1)*width)``, little-endian within
  a word; a code may straddle two words (an architectural register split
  across two physical ones, Section 4.3), and a read fetches both and ORs
  the parts, as the collector unit's OR gate does (Section 3.2.4).
* **Group of 32** (``pack_groups`` / ``unpack_groups``): 32 consecutive
  codes of ``width`` bits occupy exactly ``width`` words, so a tensor
  packs along its last axis to ``ceil(n/32) * width`` words with static
  offsets; pad codes are zero. The tensor store and the kernels use it.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.core.formats import (FLOAT_FORMATS, SLICE_BITS, _srl,
                                      decode_float, half_to_f32)

GROUP = 32


def _check_width(width: int) -> None:
    if not (1 <= width <= 32) or width % SLICE_BITS != 0:
        raise ValueError(
            f"width must be a multiple of {SLICE_BITS} in [4, 32], got {width}")


def _width_mask(width: int) -> int:
    return -1 if width == 32 else (1 << width) - 1


def packed_words(n: int, width: int) -> int:
    """Number of 32-bit words to store ``n`` codes of ``width`` bits."""
    _check_width(width)
    return -(-n * width // 32)


def stream_bits(n: int, width: int) -> int:
    """Total payload bits of a stream (before word rounding)."""
    _check_width(width)
    return n * width


def _as_int32(words64: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding 32-bit patterns -> the same bits as int32."""
    words64 = words64 & 0xFFFFFFFF
    return torch.where(words64 >= 1 << 31, words64 - (1 << 32),
                       words64).to(torch.int32)


def _stream_offsets(n: int, width: int, device):
    start = torch.arange(n, dtype=torch.int64, device=device) * width
    return start >> 5, start & 31


def pack_stream(codes: torch.Tensor, width: int) -> torch.Tensor:
    """Pack flat codes (low ``width`` bits valid) densely into
    ``packed_words(len(codes), width)`` int32 words."""
    _check_width(width)
    codes = codes.reshape(-1).to(torch.int32)
    if width == 32:
        return codes.clone()
    n = codes.shape[0]
    n_words = packed_words(n, width)
    c = codes.to(torch.int64) & _width_mask(width)
    word_lo, off = _stream_offsets(n, width, codes.device)
    lo_part = (c << off) & 0xFFFFFFFF
    spill = off + width > 32
    hi_part = torch.where(spill, c >> (32 - off), 0)
    out = torch.zeros(n_words + 1, dtype=torch.int64, device=codes.device)
    # bit ranges never overlap, so add == bitwise OR here
    out.index_add_(0, word_lo, lo_part)
    out.index_add_(0, word_lo + 1, hi_part)
    return _as_int32(out[:n_words])


def unpack_stream(packed: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_stream`: the ``n`` codes of ``width`` bits,
    int32. The Value Extractor's data path (Fig. 3): gather the word(s)
    holding each code, shift-align, OR the two parts, mask."""
    _check_width(width)
    packed = packed.reshape(-1).to(torch.int32)
    if width == 32:
        return packed[:n].clone()
    words = packed.to(torch.int64) & 0xFFFFFFFF
    word_lo, off = _stream_offsets(n, width, packed.device)
    lo_word = words[word_lo]
    hi_word = words[(word_lo + 1).clamp(max=words.shape[0] - 1)]
    spill = off + width > 32
    code = (lo_word >> off) | torch.where(spill, hi_word << (32 - off), 0)
    return (code & _width_mask(width)).to(torch.int32)


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
    if width == 16 and sys.byteorder == "little":
        # two codes a word, the low half first: the words' int16 lanes
        lanes = words.to(torch.int32).contiguous().view(torch.int16)
        return (lanes.to(torch.int32) & 0xFFFF)[..., :n]
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


def unpack_floats(words: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """Words (..., G*width) -> the f32 values of their float codes
    (..., n): ``decode_float`` of :func:`unpack_groups`. AF16 (IEEE
    binary16, two codes a word, the low half first) converts the words'
    float16 lanes in one pass and a NaN check, where the general decode
    takes about ten elementwise passes over the codes."""
    if width == 16 and sys.byteorder == "little":
        lanes = words.to(torch.int32).contiguous().view(torch.float16)
        return half_to_f32(lanes[..., :n])
    return decode_float(unpack_groups(words, width, n), FLOAT_FORMATS[width])
