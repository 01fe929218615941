"""The port's codec and group packing, bit for bit against the reference.

``repro_torch.core.formats`` / ``bitpack`` (int32 carriers) against
``repro.core.formats`` / ``bitpack`` (uint32) on all seven Table 3
widths: a sweep of special values (+-0, subnormals of both sides, +-inf,
NaN payloads, RNE ties, mantissa carries, overflow edges, f32
subnormals), random bit patterns, and group packing at lengths that are
not multiples of 32.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.core import bitpack as jbitpack
from repro.core import formats as jformats
from repro_torch.core import bitpack, formats

WIDTHS = formats.FLOAT_LADDER


def _special_bits() -> np.ndarray:
    """f32 bit patterns at every edge the narrowing conversions have."""
    pats = [0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000,
            0xFFC00001, 0x7F800001, 0x00000001, 0x807FFFFF, 0x00400000,
            0x7F7FFFFF, 0xFF7FFFFF, 0x3F800000, 0xBF800000]
    for fmt in formats.FLOAT_FORMATS.values():
        m, bias = fmt.mantissa_bits, fmt.bias
        if fmt.total_bits == 32:
            continue
        shift = 23 - m
        for e in (-bias - m - 2, -bias - m - 1, -bias - m, 1 - bias - 1,
                  1 - bias, 0, fmt.max_biased_exp - bias - 1,
                  fmt.max_biased_exp - bias):
            base = ((e + 127) & 0xFF) << 23
            half = 1 << (shift - 1)
            for man in (0, half, half - 1, half + 1, 3 * half,
                        (1 << 23) - 1, (1 << 23) - half, (1 << 23) - half - 1):
                for sign in (0, 0x80000000):
                    pats.append(sign | base | (man & 0x7FFFFF))
    return np.array(pats, np.uint64).astype(np.uint32)


def _random_bits(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 2**32, n, dtype=np.uint64).astype(np.uint32)


SWEEP = np.concatenate([_special_bits(), _random_bits(4000, 1)])


def _t(u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u32.view(np.int32).copy())


def _encode_ref(u32, bits):
    x = jnp.asarray(u32.view(np.float32))
    return np.asarray(jformats.encode_float(
        x, jformats.FLOAT_FORMATS[bits])).view(np.int32)


def _decode_ref(codes_u32, bits):
    return np.asarray(jformats.decode_float(
        jnp.asarray(codes_u32), jformats.FLOAT_FORMATS[bits])).view(np.int32)


@pytest.mark.parametrize("bits", WIDTHS)
def test_encode_float_bit_exact(bits):
    got = formats.encode_float(_t(SWEEP).view(torch.float32),
                               formats.FLOAT_FORMATS[bits])
    np.testing.assert_array_equal(got.numpy(), _encode_ref(SWEEP, bits))


@pytest.mark.parametrize("bits", WIDTHS)
def test_decode_float_bit_exact(bits):
    mask = np.uint32(0xFFFFFFFF if bits == 32 else (1 << bits) - 1)
    codes = SWEEP & mask
    if bits <= 16:                               # every code of the width
        codes = np.concatenate([codes, np.arange(2**bits, dtype=np.uint32)])
    got = formats.decode_float(_t(codes), formats.FLOAT_FORMATS[bits])
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  _decode_ref(codes, bits))


@pytest.mark.parametrize("bits", (4, 8, 12, 16, 20, 24, 28, 32))
@pytest.mark.parametrize("signed", [True, False])
def test_int_codec_bit_exact(bits, signed):
    vals = SWEEP.view(np.int32)
    enc = formats.encode_int(torch.from_numpy(vals.copy()), bits, signed)
    want_enc = np.asarray(jformats.encode_int(jnp.asarray(vals), bits,
                                              signed)).view(np.int32)
    np.testing.assert_array_equal(enc.numpy(), want_enc)
    dec = formats.decode_int(enc, bits, signed)
    want_dec = np.asarray(jformats.decode_int(
        jnp.asarray(want_enc.view(np.uint32)), bits, signed))
    np.testing.assert_array_equal(dec.numpy(), want_dec)


@pytest.mark.parametrize("bits", (4,) + WIDTHS)
def test_pack_groups_bit_exact(bits):
    """Tails that are not multiples of 32 included; pad codes are 0."""
    mask = np.uint32(0xFFFFFFFF if bits == 32 else (1 << bits) - 1)
    codes = (SWEEP[: 3 * 75] & mask).reshape(3, 75)
    want = np.asarray(jbitpack.pack_groups(jnp.asarray(codes), bits))
    got = bitpack.pack_groups(_t(codes), bits)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
    assert got.shape[-1] == bitpack.packed_group_words(75, bits)
    for n in (75, 64, 1):
        back = bitpack.unpack_groups(got, bits, n)
        want_back = np.asarray(jbitpack.unpack_groups(jnp.asarray(want),
                                                      bits, n))
        np.testing.assert_array_equal(back.numpy(), want_back.view(np.int32))


@settings(max_examples=5, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.sampled_from(WIDTHS), st.integers(0, 2**32 - 1))
def test_roundtrip_property(bits, seed):
    """encode -> pack -> unpack -> decode equals the reference's chain on
    random f32 bit patterns, 40 of them (a ragged second group; one
    length, since each new length costs the reference a compile)."""
    n = 40
    u = _random_bits(n, seed)
    fmt = formats.FLOAT_FORMATS[bits]
    words = bitpack.pack_groups(formats.encode_float(
        _t(u).view(torch.float32), fmt), bits)
    got = formats.decode_float(bitpack.unpack_groups(words, bits, n), fmt)
    jfmt = jformats.FLOAT_FORMATS[bits]
    jwords = jbitpack.pack_groups(
        jformats.encode_float(jnp.asarray(u.view(np.float32)), jfmt), bits)
    want = jformats.decode_float(jbitpack.unpack_groups(jwords, bits, n), jfmt)
    np.testing.assert_array_equal(words.numpy(),
                                  np.asarray(jwords).view(np.int32))
    np.testing.assert_array_equal(got.view(torch.int32).numpy(),
                                  np.asarray(want).view(np.int32))


def test_ladder_snap_matches_reference():
    for bits in range(0, 40):
        for below in (False, True):
            assert (formats.ladder_snap(bits, below)
                    == jformats.ladder_snap(bits, below))
