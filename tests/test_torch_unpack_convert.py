"""``unpack``, ``convert`` and ``truncate``: the port against the
reference, bit for bit.

On the CPU the port's ``ops.unpack``, ``ref.convert_ref`` and
``ref.truncate_ref`` (the plain versions) are held to the reference's
Pallas ``unpack``, ``convert`` and ``truncate``, run in interpret mode
as ``tests/test_kernels.py`` runs them, on all seven Table 3 widths; on
a card the CUDA kernels are held to the plain versions. Every comparison
is of bit patterns (int32, or int16 for bf16), so -0.0 and NaN bits
count; the tolerance is 0. The reference is imported lazily, so the
``cuda`` tests also run on a machine without JAX; they decide inside a
fixture whether there is a card and skip without one.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.core.formats import FLOAT_FORMATS, FLOAT_LADDER
from repro_torch.kernels import ops, ref

WIDTHS = FLOAT_LADDER
LANES = 128                     # columns of the reference's 2-D lanes


@pytest.fixture(scope="module")
def jref():
    """The reference's kernels and oracles, and jnp."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import convert as jconvert
    from repro.kernels import ops as jops
    from repro.kernels import ref as jax_ref
    from repro.kernels.unpack import unpack as junpack
    return {"jnp": jnp, "ref": jax_ref, "ops": jops, "unpack": junpack,
            "convert": jconvert.convert, "truncate": jconvert.truncate}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card (python -m pytest "
                    "tests/test_torch_unpack_convert.py -k cuda)")
    return torch.device("cuda")


def _awkward_floats(rng, shape) -> np.ndarray:
    """Floats over many magnitudes with the codec's special values."""
    x = (rng.standard_normal(shape) * np.exp2(rng.integers(-30, 30, shape))
         ).astype(np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 1e-40,
                         -1e-45, 65504.0, 65520.0, 6.1e-5, 5.96e-8, 2.98e-8,
                         1.0 + 2.0**-11, 3.4e38], np.float32)
    k = min(x.size, specials.size)
    x.reshape(-1)[:k] = specials[:k]
    return x


def _bit_view(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _codes(bits: int, seed: int) -> torch.Tensor:
    """Codes of ``bits`` for ``convert``: every code up to AF12, the
    edge codes of the width (zeros, subnormals, normals, inf, NaN
    payloads, both signs) and random 32-bit words, whose bits above the
    width ``decode_float`` ignores."""
    fmt = FLOAT_FORMATS[bits]
    m, maxe = fmt.mantissa_bits, fmt.max_biased_exp
    if bits <= 12:
        edges = list(range(2**bits))
    else:
        mags = [0, 1, 2, (1 << m) - 1, 1 << m, (1 << m) + 1,
                ((maxe - 1) << m) | ((1 << m) - 1), maxe << m,
                (maxe << m) | 1, (maxe << m) | (1 << (m - 1)),
                (maxe << m) | ((1 << m) - 1)]
        edges = mags + [c | (1 << (bits - 1)) for c in mags]
    rand = np.random.default_rng(seed).integers(0, 2**32, 1000,
                                                dtype=np.uint64)
    codes = np.concatenate([np.array(edges, np.uint64), rand])
    return torch.from_numpy(codes.astype(np.uint32).view(np.int32))


def _midpoints(bits: int, device=None) -> torch.Tensor:
    """The exact f32 midpoint between each pair of adjacent finite
    same-sign codes of ``bits`` (a round-to-nearest-even tie), and its
    two f32 neighbours, of both signs."""
    fmt = FLOAT_FORMATS[bits]
    top = fmt.max_biased_exp << fmt.mantissa_bits          # the +inf code
    v = ref.convert_ref(torch.arange(top, dtype=torch.int32, device=device),
                        bits)
    mid = (v[:-1] + v[1:]) * 0.5
    x = torch.cat([mid, torch.nextafter(mid, torch.full_like(mid, math.inf)),
                   torch.nextafter(mid, torch.full_like(mid, -math.inf))])
    return torch.cat([x, -x])


def _truncate_inputs() -> torch.Tensor:
    """Floats for ``truncate``: awkward floats, the ties of AF8 and
    AF12, and random bit patterns (NaN payloads and f32 subnormals
    among them)."""
    rng = np.random.default_rng(17)
    parts = [_awkward_floats(rng, (2000,)),
             _midpoints(8).numpy(), _midpoints(12).numpy(),
             rng.integers(0, 2**32, 2000, dtype=np.uint64)
             .astype(np.uint32).view(np.float32)]
    return torch.from_numpy(np.concatenate(parts))


def _lanes(t: torch.Tensor) -> torch.Tensor:
    """A flat tensor as 2-D lanes of LANES columns, zero-padded to whole
    (8, LANES) blocks: the reference's kernels take 2-D blocked input."""
    pad = -t.numel() % (8 * LANES)
    return torch.cat([t, t.new_zeros(pad)]).reshape(-1, LANES)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# the port on the CPU against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", WIDTHS)
def test_unpack_matches_reference_kernel(jref, bits, out_dtype):
    """``ops.unpack`` on the CPU against the reference's Pallas kernel."""
    jnp = jref["jnp"]
    x = _awkward_floats(np.random.default_rng(bits), (8, 64))
    words = ref.pack_ref(torch.from_numpy(x), bits)
    want = np.asarray(jref["unpack"](
        jnp.asarray(_u32(words)), bits, 64, getattr(jnp, out_dtype),
        block_rows=8, block_codes=32))
    got = ops.unpack(words, bits, 64, getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (8, 64)
    np.testing.assert_array_equal(
        _bit_view(got).numpy(),
        want.view(np.int16 if out_dtype == "bfloat16" else np.int32))


@pytest.mark.parametrize("bits", WIDTHS)
def test_unpack_any_rank_and_length(jref, bits):
    """The port's differences by design: a 3-D payload and n = 1000 (not
    a multiple of 32), which the reference's kernel refuses, against the
    reference's oracle."""
    jnp, jax_ref = jref["jnp"], jref["ref"]
    rng = np.random.default_rng(50 + bits)
    for shape in ((2, 3, 96), (3, 1000)):
        x = torch.from_numpy(_awkward_floats(rng, shape))
        words = ref.pack_ref(x, bits)
        n = shape[-1]
        for dt in ("float32", "bfloat16"):
            want = np.asarray(jax_ref.unpack_ref(
                jnp.asarray(_u32(words)), bits, n, getattr(jnp, dt)))
            got = ops.unpack(words, bits, n, getattr(torch, dt))
            assert got.shape == shape
            np.testing.assert_array_equal(
                _bit_view(got).numpy(),
                want.view(np.int16 if dt == "bfloat16" else np.int32))


def test_unpack_dispatch_record(jref):
    """``ops.unpack`` records ("unpack", "materialized") with the logical
    shape and width, as the reference's ``ops.unpack`` does; ``convert``
    and ``truncate`` record nothing, as the reference has no entry for
    them."""
    jnp, jops = jref["jnp"], jref["ops"]
    words = ref.pack_ref(torch.ones(2, 3, 40), 12)
    ops.DISPATCH_RECORDS.clear()
    ops.unpack(words, 12, 40)
    (rec,) = ops.DISPATCH_RECORDS
    jops.unpack(jnp.asarray(_u32(words)), 12, 40)
    want = jops.DISPATCH_RECORDS[-1]
    assert (rec.op, rec.path, rec.shape, rec.bits) == (
        want.op, want.path, tuple(want.shape), want.bits) == (
        "unpack", "materialized", (2, 3, 40), 12)
    ops.convert(ops.truncate(torch.ones(4), 12), 12)
    assert list(ops.DISPATCH_RECORDS) == [rec]


@pytest.mark.parametrize("bits", WIDTHS)
def test_convert_matches_reference_kernel(jref, bits):
    """Every code up to AF12, the edge codes of wider widths, and codes
    with bits set above the width, through ``ops.convert`` on the CPU
    against the reference's Pallas ``convert``."""
    jnp = jref["jnp"]
    codes = _lanes(_codes(bits, seed=bits))
    want = np.asarray(jref["convert"](jnp.asarray(_u32(codes)), bits,
                                      block=(8, LANES)))
    got = ops.convert(codes, bits)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_bit_view(got).numpy(),
                                  want.view(np.int32))


@pytest.mark.parametrize("bits", WIDTHS)
def test_truncate_matches_reference_kernel(jref, bits):
    """The formats test's special values, ties of AF8 and AF12 and their
    neighbours, random bit patterns: f32 through ``ops.truncate`` on the
    CPU against the reference's Pallas ``truncate``; the same values in
    bf16 against the reference's oracle, which widens bf16 to f32
    exactly, as the port does. (The Pallas kernel in interpret mode
    turns some bf16 NaN payloads into the canonical NaN before AF32's
    identity encode, so its output differs from its own oracle there.)"""
    from test_torch_formats import _special_bits  # the formats sweep
    jnp = jref["jnp"]
    specials = torch.from_numpy(_special_bits().view(np.float32))
    x = _lanes(torch.cat([specials, _truncate_inputs()]))
    want = np.asarray(jref["truncate"](jnp.asarray(x.numpy()), bits,
                                       block=(8, LANES)))
    got = ops.truncate(x, bits)
    assert got.dtype == torch.int32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
    xb = x.bfloat16()
    xb_bits = xb.view(torch.int16).numpy().view(jnp.bfloat16)  # same bits
    want = np.asarray(jref["ref"].truncate_ref(jnp.asarray(xb_bits), bits))
    np.testing.assert_array_equal(ops.truncate(xb, bits).numpy(),
                                  want.view(np.int32))


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain versions (card only)
# ---------------------------------------------------------------------------

def _launched(name: str, call):
    before = ops.launch_counts()[name]
    out = call()
    assert ops.launch_counts()[name] == before + 1
    return out


@pytest.mark.parametrize("bits", WIDTHS)
def test_cuda_unpack_bit_exact(cuda, bits):
    rng = np.random.default_rng(bits)
    for shape in ((8, 64), (7, 1000), (2, 3, 96), (1, 1)):
        x = torch.from_numpy(_awkward_floats(rng, shape))
        words = ref.pack_ref(x, bits)
        n = shape[-1]
        for dt in (torch.float32, torch.bfloat16):
            got = _launched("unpack", lambda: ops.unpack(words.to(cuda), bits,
                                                         n, dt))
            torch.cuda.synchronize()
            want = ref.unpack_ref(words.to(cuda), bits, n, dt)
            assert got.dtype == dt and got.shape == shape
            assert torch.equal(_bit_view(got), _bit_view(want))
            assert torch.equal(_bit_view(got.cpu()),
                               _bit_view(ref.unpack_ref(words, bits, n, dt)))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.unpack(words.to(cuda), bits, n, torch.float16)
    with pytest.raises(ValueError, match="words per row"):
        ops.unpack(words.to(cuda), bits, n + 32)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bits", WIDTHS)
def test_cuda_unpack_row_lengths(cuda, bits, out_dtype):
    """Rows of n in {32, 33, 100, 12288} (16-byte stores, scalar tails,
    rows that start unaligned), a 3-D payload, a payload whose base is
    not 16-byte aligned, and every code of AF8 to AF16 (the fast decodes
    and their inf/NaN fallback), bit for bit the plain version."""
    from repro_torch.core import bitpack

    rng = np.random.default_rng(300 + bits)
    cases = []
    for shape in ((3, 32), (5, 33), (4, 100), (2, 12288), (2, 3, 100)):
        cases.append((ref.pack_ref(torch.from_numpy(
            _awkward_floats(rng, shape)), bits).to(cuda), shape[-1]))
    words = cases[2][0].reshape(-1)
    shifted = torch.cat([words.new_zeros(1), words])[1:]   # base 4 bytes off
    assert shifted.data_ptr() % 16
    cases.append((shifted, 32 * words.numel() // bits - 5))
    if bits <= 16:
        codes = torch.arange(2**bits, dtype=torch.int32)
        cases.append((bitpack.pack_groups(codes.reshape(-1, 32), bits)
                      .to(cuda), 32))
    for words, n in cases:
        got = _launched("unpack", lambda: ops.unpack(words, bits, n,
                                                     out_dtype))
        torch.cuda.synchronize()
        want = ref.unpack_ref(words, bits, n, out_dtype)
        assert got.shape == want.shape
        assert torch.equal(_bit_view(got), _bit_view(want))


@pytest.mark.parametrize("bits", WIDTHS)
def test_cuda_convert_every_code(cuda, bits):
    """Every code up to AF20, random 32-bit words at every width (bits
    above the width set), any shape."""
    parts = [_codes(bits, seed=bits).to(cuda)]
    if bits <= 20:
        parts.append(torch.arange(2**bits, dtype=torch.int32, device=cuda))
    codes = torch.cat(parts)
    for c in (codes, codes[:-1].reshape(1, -1), codes[:96].reshape(2, 3, 16)):
        got = _launched("convert", lambda: ops.convert(c, bits))
        torch.cuda.synchronize()
        assert torch.equal(_bit_view(got), _bit_view(ref.convert_ref(c, bits)))


@pytest.mark.parametrize("bits", WIDTHS)
def test_cuda_truncate_bit_exact(cuda, bits):
    """Special values, the ties of AF8, AF12 and AF16 and their
    neighbours, every 4099th f32 bit pattern; f32 and bf16 input."""
    pattern = torch.arange(0, 2**32, 4099, dtype=torch.int64,
                           device=cuda).to(torch.int32).view(torch.float32)
    x = torch.cat([_truncate_inputs().to(cuda), _midpoints(16, cuda),
                   pattern])
    for src in (x, x.bfloat16(), x[:1000].reshape(10, 100)):
        got = _launched("truncate", lambda: ops.truncate(src, bits))
        torch.cuda.synchronize()
        assert torch.equal(got, ref.truncate_ref(src, bits))
        assert torch.equal(got.cpu(), ref.truncate_ref(src.cpu(), bits))
