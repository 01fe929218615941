"""Number formats from the paper, on int32 torch tensors.

Port of ``repro.core.formats``: the Table 3 float formats (sign + exp +
mantissa, IEEE-like with +/-inf, NaN and subnormals) and narrow two's
complement / unsigned integers. Codes live in the low ``total_bits`` of
``torch.int32`` carriers. Right shifts on int32 are arithmetic, so every
``>>`` of a value that may have its top bit set is masked (``_srl``).

These functions are the port's reference semantics; the CUDA routines in
``repro_torch/kernels/csrc/codec.cuh`` implement the same bits.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

SLICE_BITS = 4                      # Section 3.2: slices are 4 bits


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """An IEEE-754-like float format: 1 sign + exp_bits + mantissa_bits."""

    name: str
    exp_bits: int
    mantissa_bits: int

    @property
    def total_bits(self) -> int:
        return 1 + self.exp_bits + self.mantissa_bits

    @property
    def bias(self) -> int:
        return (1 << (self.exp_bits - 1)) - 1

    @property
    def max_biased_exp(self) -> int:
        return (1 << self.exp_bits) - 1


# Table 3: total bits -> (exponent bits, mantissa bits); sign bit implied.
FLOAT_FORMATS: Dict[int, FloatFormat] = {
    32: FloatFormat("AF32", 8, 23),
    28: FloatFormat("AF28", 7, 20),
    24: FloatFormat("AF24", 6, 17),
    20: FloatFormat("AF20", 5, 14),
    16: FloatFormat("AF16", 5, 10),
    12: FloatFormat("AF12", 4, 7),
    8: FloatFormat("AF8", 3, 4),
}
FLOAT_LADDER: Tuple[int, ...] = (8, 12, 16, 20, 24, 28, 32)

_INT32_MIN = -(1 << 31)


def ladder_snap(bits: int, below: bool = False) -> int:
    """Widest Table 3 rung <= ``bits`` (strictly < with ``below``),
    floored at the narrowest rung."""
    rungs = [r for r in FLOAT_LADDER if (r < bits if below else r <= bits)]
    return rungs[-1] if rungs else FLOAT_LADDER[0]


def slices_for_bits(bits: int) -> int:
    if bits <= 0:
        raise ValueError(f"operand width must be positive, got {bits}")
    return -(-bits // SLICE_BITS)


def round_bits_to_slice(bits: int) -> int:
    """Round a bitwidth up to the 4-bit slice granularity of Section 3.2."""
    return slices_for_bits(bits) * SLICE_BITS


def _srl(u: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 lanes by a constant ``k``."""
    if k == 0:
        return u
    return (u >> k) & ((1 << (32 - k)) - 1)


def _popcount21(v: torch.Tensor) -> torch.Tensor:
    """Population count of non-negative int32 lanes below 2**24 (SWAR):
    the stand-in for ``jnp.bitwise_count``."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v + (v >> 8) + (v >> 16)) & 0x3F


def f32_to_bits(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


# ---------------------------------------------------------------------------
# Encode: f32 -> narrow float code (the Value Truncator's step 1, Fig. 5)
# ---------------------------------------------------------------------------

def encode_float(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """float32 values -> ``fmt`` codes (int32, low total_bits valid).

    Round-to-nearest-even; keeps signed zero, +/-inf and NaN (as mantissa
    ``1 << (m-1)``); subnormals on underflow, inf on overflow; f32
    subnormal inputs flush to signed zero. AF32 is the identity."""
    u = f32_to_bits(x)
    if fmt.total_bits == 32:
        return u.clone()
    m_t = fmt.mantissa_bits
    shift = 23 - m_t
    sign = _srl(u, 31)
    exp = (u >> 23) & 0xFF
    man = u & 0x7FFFFF
    e_new = exp - 127 + fmt.bias

    # normal path: RNE-round the mantissa from 23 -> m_t bits
    kept = man >> shift
    round_bit = (man >> (shift - 1)) & 1
    sticky = ((man & ((1 << (shift - 1)) - 1)) != 0).to(torch.int32)
    man_rounded = kept + (round_bit & (sticky | (kept & 1)))
    man_carry = man_rounded >> m_t
    e_norm = e_new + man_carry
    man_norm = torch.where(man_carry > 0, 0, man_rounded)

    # subnormal path: RNE over the full 24-bit significand
    full = man | (1 << 23)
    sub_shift = ((1 - e_new) + shift).clamp(0, 31)
    kept = full >> sub_shift
    rb_pos = (sub_shift - 1).clamp(min=0)
    round_bit = torch.where(sub_shift > 0, (full >> rb_pos) & 1, 0)
    one = torch.ones_like(sub_shift)
    below_mask = torch.where(
        sub_shift > 1, (one << (sub_shift - 1).clamp(min=1)) - 1, 0)
    sticky = ((full & below_mask) != 0).to(torch.int32)
    man_sub = kept + (round_bit & (sticky | (kept & 1)))
    sub_to_norm = man_sub >> m_t          # rounds up to the smallest normal
    man_sub = torch.where(sub_to_norm > 0, 0, man_sub)

    is_sub = e_new <= 0
    e_out = torch.where(is_sub, sub_to_norm, e_norm)
    man_out = torch.where(is_sub, man_sub, man_norm)

    maxe = fmt.max_biased_exp
    overflow = e_out >= maxe
    e_out = torch.where(overflow, maxe, e_out)
    man_out = torch.where(overflow, 0, man_out)

    src_special = exp == 0xFF
    src_nan = src_special & (man != 0)
    e_out = torch.where(src_special, maxe, e_out)
    man_out = torch.where(
        src_special, torch.where(src_nan, 1 << (m_t - 1), 0), man_out)

    src_zero = exp == 0                   # zero and f32 subnormals
    e_out = torch.where(src_zero, 0, e_out)
    man_out = torch.where(src_zero, 0, man_out)

    return ((sign << (fmt.total_bits - 1)) | (e_out << m_t)
            | (man_out & ((1 << m_t) - 1))).to(torch.int32)


# ---------------------------------------------------------------------------
# Decode: narrow float code -> f32 (the Value Converter, Section 3.2.5)
# ---------------------------------------------------------------------------

def decode_float(code: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """Expand ``fmt`` codes (int32) to float32. Exact; every NaN code
    becomes the canonical mantissa ``1 << 22`` with its sign."""
    code = code.to(torch.int32)
    if fmt.total_bits == 32:
        return code.contiguous().view(torch.float32)
    m_t = fmt.mantissa_bits
    maxe = fmt.max_biased_exp
    sign = (code >> (fmt.total_bits - 1)) & 1
    exp = (code >> m_t) & maxe
    man = code & ((1 << m_t) - 1)

    is_special = exp == maxe
    is_zero = (exp == 0) & (man == 0)
    is_sub = (exp == 0) & (man != 0)

    e32 = exp - fmt.bias + 127
    m32 = man << (23 - m_t)

    # subnormals: leading-one index via bit smearing + popcount
    v = man.clamp(min=1)
    for s in (1, 2, 4, 8, 16):
        v = v | (v >> s)
    top = _popcount21(v) - 1
    m_sub = (man << (23 - top)) & 0x7FFFFF
    e_sub = (top - m_t) + (1 - fmt.bias) + 127

    e32 = torch.where(is_sub, e_sub, e32)
    m32 = torch.where(is_sub, m_sub, m32)
    e32 = torch.where(is_special, 255, e32)
    m32 = torch.where(is_special, torch.where(man != 0, 1 << 22, 0), m32)
    e32 = torch.where(is_zero, 0, e32)
    m32 = torch.where(is_zero, 0, m32)

    out = (e32 << 23) | m32 | torch.where(sign != 0, _INT32_MIN, 0)
    return out.to(torch.int32).contiguous().view(torch.float32)


# ---------------------------------------------------------------------------
# Narrow integers: two's complement / unsigned codes
# ---------------------------------------------------------------------------

def _int_mask(bits: int) -> int:
    return -1 if bits == 32 else (1 << bits) - 1


def encode_int(x: torch.Tensor, bits: int, signed: bool) -> torch.Tensor:
    """Truncate integer values to ``bits``-bit codes (int32 carrier)."""
    if not (1 <= bits <= 32):
        raise ValueError(f"bits must be in [1, 32], got {bits}")
    del signed            # encoding is the same; signedness matters on decode
    return x.to(torch.int32) & _int_mask(bits)


def decode_int(code: torch.Tensor, bits: int, signed: bool) -> torch.Tensor:
    """Sign- or zero-extend ``bits``-bit codes back to int32."""
    code = code.to(torch.int32)
    if bits == 32:
        return code
    code = code & _int_mask(bits)
    if not signed:
        return code
    sbit = 1 << (bits - 1)
    return (code ^ sbit) - sbit

