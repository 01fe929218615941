"""Microarchitectural model of the proposed register file (Section 3.2).

Port of ``repro.core.regfile``. Physical storage is a banked array of
*warp registers* (32 threads x 32 bits). A read goes through the
indirection table and the **Value Extractor** (32 parallel TVEs, each
eight 9:1 slice muxes and a pad mux, Fig. 4); integer operands are then
sign- or zero-extended and float operands expanded to f32 by the
**Value Converter** (Section 3.2.5). A write runs the **Value
Truncator** (Fig. 5): narrow the float, scatter the slices, and write
back under a mask that drives only the bit lines of the allocated
slices.

The slice gather and scatter networks are configured per kernel (the
indirection table is loaded before launch), so their selects come from
the entry masks on the host, as in hardware the mask bits drive them.

Lanes are int32 tensors on the storage's device. The Value Converter
and Truncator of float operands are ``kernels.ops.convert`` and
``ops.truncate`` (B8): the CUDA kernels on the card, their plain
versions on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Union

import torch

from repro_torch.core.allocator import Allocation, IndirectionEntry
from repro_torch.core.formats import (SLICE_BITS, SLICES_PER_REGISTER, _srl,
                                      decode_int, encode_int,
                                      narrowest_at_least)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

# Fermi register file geometry (Table 2).
NUM_BANKS = 16
ENTRIES_PER_BANK = 64
BANK_WIDTH_BITS = 1024          # one warp register: 32 threads x 32 bits
WARP_SIZE = 32


def _positions(mask: int) -> List[int]:
    return [s for s in range(SLICES_PER_REGISTER) if mask & (1 << s)]


def _signed32(bits: int) -> int:
    """A 32-bit pattern as the int32 value that carries it."""
    return bits - (1 << 32) if bits >= 1 << 31 else bits


def extract_slices(word: torch.Tensor, mask: int,
                   out_base: int) -> torch.Tensor:
    """TVE slice gather: route ``mask``'s slices of ``word`` to contiguous
    output slices starting at ``out_base`` (LSB first). A mux network."""
    out = torch.zeros_like(word, dtype=torch.int32)
    for j, pos in enumerate(_positions(mask)):
        nib = _srl(word, SLICE_BITS * pos) & 0xF
        out = out | (nib << (SLICE_BITS * (out_base + j)))
    return out


def scatter_slices(value: torch.Tensor, mask: int,
                   in_base: int) -> torch.Tensor:
    """TVT slice scatter: the inverse routing of :func:`extract_slices`."""
    out = torch.zeros_like(value, dtype=torch.int32)
    for j, pos in enumerate(_positions(mask)):
        nib = _srl(value, SLICE_BITS * (in_base + j)) & 0xF
        out = out | (nib << (SLICE_BITS * pos))
    return out


def mask_bits(mask: int) -> int:
    """Bit-lane mask driven during the masked writeback (Section 3.2.6),
    as the int32 value that carries its 32 bits."""
    bits = 0
    for pos in _positions(mask):
        bits |= 0xF << (SLICE_BITS * pos)
    return _signed32(bits)


@dataclasses.dataclass
class PackedRegisterFile:
    """A warp's packed register file and its indirection tables.

    ``storage``: (num_physical_regs, WARP_SIZE) int32, on ``device`` (the
    card unless the caller names the CPU) when not given; writes update
    it in place. Hardware keeps separate source and destination tables
    (Section 3.2.2) with identical content, so one ``entries`` dict backs
    both here while reads and writes are counted per table.
    """

    allocation: Allocation
    num_regs: int = 256
    storage: Optional[torch.Tensor] = None
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        if self.storage is None:
            self.storage = torch.zeros((self.num_regs, WARP_SIZE),
                                       dtype=torch.int32,
                                       device=resolve_device(self.device))
        self.src_table_reads = 0
        self.dst_table_reads = 0
        self.register_fetches = 0       # physical register reads
        self.double_fetches = 0         # reads that needed two registers

    # -- read path: indirection lookup -> fetch -> TVE -> (VC) -------------
    def read(self, name: str) -> torch.Tensor:
        """The architectural register as int32 or float32 lanes."""
        entry = self.allocation.entries[name]
        self.src_table_reads += 1
        code = self._fetch_code(entry)
        if entry.is_float:                          # Value Converter
            return ops.convert(code, narrowest_at_least(entry.bits).total_bits)
        return decode_int(code, entry.bits, entry.signed)

    def read_raw(self, name: str) -> torch.Tensor:
        """The aligned, undecoded code (what leaves the Value Extractor)."""
        return self._fetch_code(self.allocation.entries[name])

    def _fetch_code(self, entry: IndirectionEntry) -> torch.Tensor:
        self.register_fetches += 1
        part = extract_slices(self.storage[entry.reg0], entry.mask0, 0)
        if entry.split:
            self.register_fetches += 1
            self.double_fetches += 1
            n0 = bin(entry.mask0).count("1")
            # the collector unit's OR gate merges the two fetches (3.2.4)
            part = part | extract_slices(self.storage[entry.reg1],
                                         entry.mask1, n0)
        return part

    # -- write path: (VT) -> slice scatter -> masked writeback -------------
    def write(self, name: str, values) -> None:
        entry = self.allocation.entries[name]
        self.dst_table_reads += 1
        values = torch.as_tensor(values, device=self.storage.device)
        if entry.is_float:                          # Value Truncator
            code = ops.truncate(values.to(torch.float32),
                                narrowest_at_least(entry.bits).total_bits)
        else:
            code = encode_int(values.to(torch.int32), entry.bits,
                              entry.signed)
        n0 = bin(entry.mask0).count("1")
        for reg, mask, base in ((entry.reg0, entry.mask0, 0),
                                (entry.reg1, entry.mask1, n0)):
            if not mask:
                continue
            lanes = scatter_slices(code, mask, base)
            self.storage[reg] = (self.storage[reg] & ~mask_bits(mask)) | lanes

    # -- bookkeeping ---------------------------------------------------------
    def bank_of(self, reg: int) -> int:
        return reg % NUM_BANKS

    @property
    def double_fetch_rate(self) -> float:
        return self.double_fetches / max(self.register_fetches, 1)


def baseline_register_file(num_regs: int = 256,
                           device: Optional[Union[str, torch.device]] = None
                           ) -> PackedRegisterFile:
    """A conventional 32-bit-granularity register file in the same model:
    every architectural register owns all 8 slices of one physical one."""
    entries = {
        f"r{i}": IndirectionEntry(name=f"r{i}", reg0=i, mask0=0xFF,
                                  is_float=False, signed=True, bits=32)
        for i in range(num_regs)
    }
    alloc = Allocation(
        entries=entries,
        register_pressure=num_regs,
        registers_used=num_regs,
        total_slices=num_regs * SLICES_PER_REGISTER,
        baseline_pressure=num_regs,
        split_count=0,
    )
    return PackedRegisterFile(allocation=alloc, num_regs=num_regs,
                              device=device)
