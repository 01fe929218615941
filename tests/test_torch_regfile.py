"""The register-slice allocator, the packed register file and the stream
packing: the port against the reference, exactly.

``SliceAllocator`` must give the reference's ``Allocation`` (entries in
the same order, pressures, split count, table words) on drawn operand
lists, with and without ``prefer_contiguous`` and ``whole_program``.
``PackedRegisterFile`` must read and write the same lanes, the same
storage words and the same fetch counters as the reference's at every
Table 3 float width and every integer width 1-32 (its floats go through
``ops.truncate`` / ``ops.convert``, the plain versions here).
``pack_stream`` / ``unpack_stream`` must give the reference's words and
codes. The reference is imported in a fixture, so the ``cuda`` test, the
card's register file against the CPU's, runs without JAX; it skips
without a card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import bitpack
from repro_torch.core.allocator import (IndirectionEntry, Operand,
                                        SliceAllocator, pack_operand_table)
from repro_torch.core.formats import (FLOAT_LADDER, format_for_bits,
                                      narrowest_at_least)
from repro_torch.core.regfile import (PackedRegisterFile,
                                      baseline_register_file, extract_slices,
                                      mask_bits, scatter_slices)
from repro_torch.interop import allocation_from_fields

WARP = 32


@pytest.fixture(scope="module")
def rref():
    """The reference's allocator, register file and bitpack, and jnp."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import allocator, bitpack as rbitpack, regfile
    return {"jnp": jnp, "allocator": allocator, "regfile": regfile,
            "bitpack": rbitpack}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: runs on the card (python -m pytest "
                    "tests/test_torch_regfile.py -k cuda)")
    return torch.device("cuda")


def _fields(op: Operand) -> dict:
    return dataclasses.asdict(op)


def _ref_alloc(rref, operands, **kw):
    ro = [rref["allocator"].Operand(**_fields(o)) for o in operands]
    return rref["allocator"].SliceAllocator(
        prefer_contiguous=kw.pop("prefer_contiguous", False)).allocate(
            ro, **kw)


def _same_allocation(rref, operands, prefer_contiguous, whole_program):
    ref = _ref_alloc(rref, operands, prefer_contiguous=prefer_contiguous,
                     whole_program=whole_program)
    got = SliceAllocator(prefer_contiguous=prefer_contiguous).allocate(
        operands, whole_program=whole_program)
    want = allocation_from_fields(dataclasses.asdict(ref))
    assert got == want
    assert list(got.entries) == list(want.entries)
    assert got.table_words() == ref.table_words()
    assert pack_operand_table(list(got.entries.values())) == \
        rref["allocator"].pack_operand_table(list(ref.entries.values()))
    assert got.ideal_pressure == ref.ideal_pressure
    assert got.compression_ratio == ref.compression_ratio
    return got


_operand = st.tuples(st.integers(1, 32), st.booleans(), st.booleans(),
                     st.integers(0, 24), st.integers(1, 12))


@settings(max_examples=25, deadline=None, database=None)
@given(st.lists(_operand, min_size=1, max_size=40), st.booleans(),
       st.booleans())
def test_slice_allocator_matches_reference(rref, ops, prefer_contiguous,
                                           whole_program):
    operands = [Operand(name=f"v{i}", bits=b, is_float=f, signed=s,
                        start=t, end=t + d)
                for i, (b, f, s, t, d) in enumerate(ops)]
    _same_allocation(rref, operands, prefer_contiguous, whole_program)


def test_slice_allocator_ties_keep_input_order(rref):
    """Equal (start, -slices) keys keep the input order (a stable sort):
    the same operands in two orders give two different tables, each the
    reference's."""
    ops = [Operand(name=f"v{i}", bits=b, start=0, end=4)
           for i, b in enumerate((12, 12, 20, 8, 12, 8))]
    a = _same_allocation(rref, ops, False, False)
    b = _same_allocation(rref, ops[::-1], False, False)
    assert ({n: e.encode() for n, e in a.entries.items()}
            != {n: e.encode() for n, e in b.entries.items()})


def test_slice_allocator_out_of_registers(rref):
    ops = [Operand(name=f"v{i}", bits=32) for i in range(3)]
    with pytest.raises(RuntimeError, match="out of physical registers"):
        SliceAllocator(max_registers=2).allocate(ops, whole_program=True)


@settings(max_examples=40, deadline=None, database=None)
@given(st.integers(0, 255), st.integers(0, 255), st.integers(0, 255),
       st.integers(0, 255))
def test_indirection_entry_round_trip(rref, r0, m0, r1, m1):
    e = IndirectionEntry("x", reg0=r0, mask0=m0, reg1=r1, mask1=m1)
    ref = rref["allocator"].IndirectionEntry("x", reg0=r0, mask0=m0,
                                             reg1=r1, mask1=m1)
    word = e.encode()
    assert word == ref.encode() and 0 <= word < 2**32
    d = IndirectionEntry.decode(word, "x")
    assert (d.reg0, d.mask0, d.reg1, d.mask1) == (r0, m0, r1, m1)
    assert d.slice_positions() == ref.slice_positions()
    assert (d.split, d.slices) == (ref.split, ref.slices)


def test_indirection_entry_refuses_wide_registers():
    with pytest.raises(ValueError, match="8 bits"):
        IndirectionEntry("x", reg0=256, mask0=1).encode()


def test_slice_networks_match_reference(rref):
    jnp = rref["jnp"]
    rf = rref["regfile"]
    rng = np.random.default_rng(3)
    word = rng.integers(0, 2**32, WARP, dtype=np.uint64).astype(np.uint32)
    tword = torch.from_numpy(word.view(np.int32).copy())
    for mask in (0x01, 0x80, 0xB0, 0x4C, 0xFF, 0x0F, 0xF0):
        for base in range(0, 9 - bin(mask).count("1")):
            got = extract_slices(tword, mask, base).numpy().view(np.uint32)
            assert (got == np.asarray(rf.extract_slices(
                jnp.asarray(word), mask, base))).all()
            got = scatter_slices(tword, mask, base).numpy().view(np.uint32)
            assert (got == np.asarray(rf.scatter_slices(
                jnp.asarray(word), mask, base))).all()
        assert mask_bits(mask) & 0xFFFFFFFF == int(rf.mask_bits(mask))


def test_format_helpers_match_reference(rref):
    from repro.core import formats as rformats
    for bits in range(1, 34):
        assert narrowest_at_least(bits).name == \
            rformats.narrowest_at_least(bits).name
        if bits in FLOAT_LADDER:
            f, r = format_for_bits(bits), rformats.format_for_bits(bits)
            assert (f.name, f.exp_bits, f.mantissa_bits) == \
                (r.name, r.exp_bits, r.mantissa_bits)
        else:
            with pytest.raises(ValueError):
                format_for_bits(bits)
            with pytest.raises(ValueError):
                rformats.format_for_bits(bits)


def _register_operands():
    """Every Table 3 float width and every integer width 1-32, signed and
    unsigned, all live at once (splits included)."""
    ops = [Operand(name=f"f{b}", bits=b, is_float=True, signed=True)
           for b in FLOAT_LADDER]
    ops += [Operand(name=f"{'s' if s else 'u'}{w}", bits=w, signed=s)
            for w in range(1, 33) for s in (True, False)]
    return ops


def _lane_values(op: Operand, rng) -> np.ndarray:
    """32 lanes for ``op``: floats over many magnitudes with the codec's
    special values; integers anywhere in the operand's range (as int32
    bits)."""
    if op.is_float:
        x = (rng.standard_normal(WARP) * np.exp2(rng.integers(-20, 20, WARP))
             ).astype(np.float32)
        x[:8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, 65504.0, 3.4e38]
        return x
    if op.signed:
        lo, hi = -(1 << (op.bits - 1)), (1 << (op.bits - 1)) - 1
    else:
        lo, hi = 0, (1 << op.bits) - 1
    v = rng.integers(lo, hi + 1, WARP, dtype=np.int64)
    v[:2] = (lo, hi)
    return (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


def _run_register_file(rf, operands, values, to_lanes):
    """Write every operand, then read each back: (reads, raw codes)."""
    for op in operands:
        rf.write(op.name, to_lanes(values[op.name]))
    reads = {op.name: rf.read(op.name) for op in operands}
    raws = {op.name: rf.read_raw(op.name) for op in operands}
    return reads, raws


def _counters(rf):
    return (rf.src_table_reads, rf.dst_table_reads, rf.register_fetches,
            rf.double_fetches)


def test_packed_register_file_matches_reference(rref):
    jnp = rref["jnp"]
    operands = _register_operands()
    ref_alloc = _ref_alloc(rref, operands, whole_program=True)
    alloc = allocation_from_fields(dataclasses.asdict(ref_alloc))
    assert alloc.split_count > 0
    rng = np.random.default_rng(0)
    values = {op.name: _lane_values(op, rng) for op in operands}

    ref_rf = rref["regfile"].PackedRegisterFile(allocation=ref_alloc)
    rf = PackedRegisterFile(allocation=alloc, device="cpu")
    want_reads, want_raws = _run_register_file(ref_rf, operands, values,
                                               jnp.asarray)
    reads, raws = _run_register_file(rf, operands, values, torch.from_numpy)
    for op in operands:
        assert (_bits(reads[op.name].numpy())
                == _bits(want_reads[op.name])).all(), op
        assert (_bits(raws[op.name].numpy())
                == _bits(want_raws[op.name])).all(), op
    assert (_bits(rf.storage.numpy()) == _bits(ref_rf.storage)).all()
    assert _counters(rf) == _counters(ref_rf)
    assert rf.double_fetch_rate == ref_rf.double_fetch_rate


def test_baseline_register_file_matches_reference(rref):
    ref_rf = rref["regfile"].baseline_register_file(16)
    rf = baseline_register_file(16, device="cpu")
    assert rf.allocation == allocation_from_fields(
        dataclasses.asdict(ref_rf.allocation))
    rng = np.random.default_rng(1)
    for i in range(16):
        v = rng.integers(-2**31, 2**31, WARP, dtype=np.int64).astype(np.int32)
        rf.write(f"r{i}", torch.from_numpy(v))
        ref_rf.write(f"r{i}", rref["jnp"].asarray(v))
        assert (rf.read(f"r{i}").numpy() == v).all()
        assert (np.asarray(ref_rf.read(f"r{i}")) == v).all()
    assert (_bits(rf.storage.numpy()) == _bits(ref_rf.storage)).all()
    assert _counters(rf) == _counters(ref_rf)
    assert rf.bank_of(17) == ref_rf.bank_of(17)


@pytest.mark.parametrize("width", range(1, 33))
def test_stream_packing_matches_reference(rref, width):
    jnp, rb = rref["jnp"], rref["bitpack"]
    rng = np.random.default_rng(width)
    if width % 4:
        with pytest.raises(ValueError):
            rb.pack_stream(jnp.zeros(3, jnp.uint32), width)
        with pytest.raises(ValueError):
            bitpack.pack_stream(torch.zeros(3, dtype=torch.int32), width)
        with pytest.raises(ValueError):
            bitpack.unpack_stream(torch.zeros(3, dtype=torch.int32), width,
                                  3)
        return
    for n in (1, 7, 31, 33, 101, 1000):
        codes = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
        want = np.asarray(rb.pack_stream(jnp.asarray(codes), width))
        got = bitpack.pack_stream(torch.from_numpy(codes.view(np.int32)),
                                  width)
        assert got.dtype == torch.int32
        assert got.shape[0] == bitpack.packed_words(n, width) == want.size
        assert (_bits(got.numpy()) == want).all()
        back = bitpack.unpack_stream(got, width, n)
        assert (_bits(back.numpy()) == np.asarray(
            rb.unpack_stream(jnp.asarray(want), width, n))).all()
        assert bitpack.stream_bits(n, width) == rb.stream_bits(n, width)


def test_cuda_register_file_matches_cpu(cuda):
    """The card's register file (B8's CUDA truncate and convert for the
    floats) against the CPU's: the same lanes, storage and counters."""
    operands = _register_operands()
    alloc = SliceAllocator().allocate(operands, whole_program=True)
    rng = np.random.default_rng(0)
    values = {op.name: _lane_values(op, rng) for op in operands}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        rf = PackedRegisterFile(allocation=alloc, device=dev)
        reads, raws = _run_register_file(
            rf, operands, values, lambda v: torch.from_numpy(v).to(dev))
        out[dev.type] = (reads, raws, rf.storage.cpu(), _counters(rf))
    g, c = out["cuda"], out["cpu"]
    for op in operands:
        assert torch.equal(g[0][op.name].cpu().view(torch.int32),
                           c[0][op.name].view(torch.int32)), op
        assert torch.equal(g[1][op.name].cpu(), c[1][op.name])
    assert torch.equal(g[2], c[2]) and g[3] == c[3]
