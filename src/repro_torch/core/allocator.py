"""Register-slice allocation (Section 4.3) and the KV page pool.

Port of ``repro.core.allocator``, both halves. Host Python only.

**Slices.** Operands annotated with a bitwidth (range analysis for
integers, precision tuning for floats) are packed into the 4-bit slices
of 32-bit physical registers. An operand may be split across at most two
physical registers; its placement is an indirection-table entry of two
register ids and two 8-bit slice masks, the 32-bit (r0, m0, r1, m1)
entry of Fig. 7. A linear scan over live ranges gives the register
pressure, the paper's figure of merit (Fig. 9); ``whole_program=True``
makes every operand always live.

**KV pages.** ``KVPagePool`` (with ``PoolExhausted`` and
``KVPagePool.chain_key``) hands fixed-size KV-cache pages to requests.
The device buffers indexed by the page ids belong to the caller
(``ServeEngine``'s paged decode state).

Page id 0 is the *scrap page*: the write target of unallocated
page-table entries, never handed out, so ids run 1..n_pages. Capacity
falls in three buckets:

* **used**: allocated pages (refcount >= 1);
* **reserved**: pages promised to admitted requests but not allocated
  yet (``alloc(reserved=True)`` draws these down), so a request admitted
  against its own worst case never runs out mid-flight;
* **free**: ``n_pages - used - reserved``, what admission may promise.

Prefix sharing: a full page of prompt tokens registers under a chain key
(hash of the parent chain plus the page's tokens). A later request whose
prompt matches the chain retains the page (refcount + 1) instead of
recomputing it; when the refcount drops to zero the page unregisters and
returns to the free list. A writer copies a shared page
(``refcount(page) > 1``) before changing it.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import math
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.formats import (REGISTER_BITS, SLICES_PER_REGISTER,
                                      round_bits_to_slice, slices_for_bits)


@dataclasses.dataclass(frozen=True)
class Operand:
    """One architectural register / logical value to be packed."""

    name: str
    bits: int                      # bits needed (pre slice-rounding)
    is_float: bool = False
    signed: bool = False
    start: int = 0                 # live range [start, end)
    end: int = 1 << 30

    @property
    def slices(self) -> int:
        return slices_for_bits(self.bits)

    @property
    def slice_bits(self) -> int:
        return round_bits_to_slice(self.bits)


@dataclasses.dataclass(frozen=True)
class IndirectionEntry:
    """(r0, m0, r1, m1): the 32-bit indirection-table entry of Fig. 7.

    Convention (matches Fig. 3): the operand's slices in LSB-to-MSB order
    occupy the *set bits of mask0 in increasing slice index*, then the set
    bits of mask1.
    """

    name: str
    reg0: int
    mask0: int
    reg1: int = 0
    mask1: int = 0
    is_float: bool = False
    signed: bool = False
    bits: int = REGISTER_BITS

    @property
    def split(self) -> bool:
        return self.mask1 != 0

    @property
    def slices(self) -> int:
        return bin(self.mask0).count("1") + bin(self.mask1).count("1")

    def encode(self) -> int:
        """Pack into the 32-bit table word: r0|m0|r1|m1, 8 bits each."""
        for field, val in (("reg0", self.reg0), ("reg1", self.reg1)):
            if not 0 <= val < 256:
                raise ValueError(f"{field}={val} does not fit in 8 bits")
        return (
            (self.reg0 & 0xFF)
            | ((self.mask0 & 0xFF) << 8)
            | ((self.reg1 & 0xFF) << 16)
            | ((self.mask1 & 0xFF) << 24)
        )

    @staticmethod
    def decode(word: int, name: str = "", **meta) -> "IndirectionEntry":
        return IndirectionEntry(
            name=name,
            reg0=word & 0xFF,
            mask0=(word >> 8) & 0xFF,
            reg1=(word >> 16) & 0xFF,
            mask1=(word >> 24) & 0xFF,
            **meta,
        )

    def slice_positions(self) -> Tuple[Tuple[int, int], ...]:
        """((reg, slice_index), ...) for operand slices LSB->MSB."""
        pos = []
        for reg, mask in ((self.reg0, self.mask0), (self.reg1, self.mask1)):
            for s in range(SLICES_PER_REGISTER):
                if mask & (1 << s):
                    pos.append((reg, s))
        return tuple(pos)


@dataclasses.dataclass
class Allocation:
    entries: Dict[str, IndirectionEntry]
    register_pressure: int          # max simultaneously-live physical regs
    registers_used: int             # distinct physical registers touched
    total_slices: int               # payload slices across all operands
    baseline_pressure: int          # 1 operand = 1 register (the baseline RF)
    split_count: int                # operands split across two registers

    @property
    def ideal_pressure(self) -> int:
        return max(1, math.ceil(self.total_slices / SLICES_PER_REGISTER))

    @property
    def compression_ratio(self) -> float:
        return self.baseline_pressure / max(self.register_pressure, 1)

    def table_words(self) -> List[int]:
        return [e.encode() for e in self.entries.values()]


class SliceAllocator:
    """First-fit slice packer with <=2-way operand split (Section 4.3).

    ``prefer_contiguous``: when True, avoid splitting whenever a single
    register can hold the operand — the paper's power trade-off (§6.5:
    contiguous placement avoids double fetches; splitting minimizes
    fragmentation).
    """

    def __init__(self, prefer_contiguous: bool = False,
                 max_registers: int = 256):
        self.prefer_contiguous = prefer_contiguous
        self.max_registers = max_registers

    def allocate(self, operands: Sequence[Operand],
                 whole_program: bool = False) -> Allocation:
        ops = list(operands)
        if whole_program:
            ops = [dataclasses.replace(o, start=0, end=1) for o in ops]
        # Linear scan: process operand definitions in program order;
        # free registers when every resident operand has died.
        ops_sorted = sorted(ops, key=lambda o: (o.start, -o.slices))
        free: Dict[int, int] = {}          # reg id -> free-slice bitmask
        # reg id -> [(operand, mask)] currently resident
        expiry: Dict[int, List[Tuple[Operand, int]]] = {}
        entries: Dict[str, IndirectionEntry] = {}
        next_reg = 0
        live_regs: set = set()
        pressure = 0
        split_count = 0

        def _expire(now: int) -> None:
            for reg in list(live_regs):
                residents = expiry.get(reg, [])
                dead = [(o, m) for o, m in residents if o.end <= now]
                residents = [(o, m) for o, m in residents if o.end > now]
                for _, m in dead:           # reclaim the dead slices
                    free[reg] = free.get(reg, 0) | m
                if residents:
                    expiry[reg] = residents
                else:
                    expiry.pop(reg, None)
                    free.pop(reg, None)     # retired: fully free register
                    live_regs.discard(reg)

        full_mask = (1 << SLICES_PER_REGISTER) - 1

        def _grab(reg: int, mask: int, count: int) -> int:
            """Take ``count`` lowest free slices of ``reg``; return mask."""
            taken = 0
            got = 0
            for s in range(SLICES_PER_REGISTER):
                if got == count:
                    break
                if mask & (1 << s):
                    taken |= 1 << s
                    got += 1
            assert got == count
            free[reg] = mask & ~taken
            return taken

        def _open_register() -> int:
            nonlocal next_reg
            if next_reg >= self.max_registers:
                raise RuntimeError(
                    f"out of physical registers (>{self.max_registers})"
                )
            reg = next_reg
            next_reg += 1
            free[reg] = full_mask
            return reg

        for op in ops_sorted:
            _expire(op.start)
            need = op.slices
            # Candidate registers currently holding live operands, most-full
            # first (first-fit-decreasing flavour keeps fragmentation low).
            cands = sorted(
                (r for r in live_regs if free.get(r, 0)),
                key=lambda r: bin(free[r]).count("1"),
            )
            placed: List[Tuple[int, int]] = []   # (reg, mask)

            single = next(
                (r for r in cands if bin(free[r]).count("1") >= need), None
            )
            if single is not None:
                placed = [(single, _grab(single, free[single], need))]
            elif not self.prefer_contiguous and cands:
                # Split: largest partial + remainder in one more register.
                first = max(cands, key=lambda r: bin(free[r]).count("1"))
                avail = bin(free[first]).count("1")
                take = min(avail, need)
                rest = need - take
                second = next(
                    (
                        r for r in cands
                        if r != first and bin(free[r]).count("1") >= rest
                    ),
                    None,
                )
                if rest > 0 and second is None:
                    second = _open_register()
                m0 = _grab(first, free[first], take)
                placed = [(first, m0)]
                if rest > 0:
                    placed.append((second, _grab(second, free[second], rest)))
            if not placed:
                reg = _open_register()
                placed = [(reg, _grab(reg, free[reg], need))]

            if len(placed) > 2:  # pragma: no cover - structurally impossible
                raise AssertionError("operand split across >2 registers")
            if len(placed) == 2:
                split_count += 1
            (r0, m0), *tail = placed
            r1, m1 = tail[0] if tail else (0, 0)
            entries[op.name] = IndirectionEntry(
                name=op.name, reg0=r0, mask0=m0, reg1=r1, mask1=m1,
                is_float=op.is_float, signed=op.signed, bits=op.slice_bits,
            )
            for reg, mask in placed:
                live_regs.add(reg)
                expiry.setdefault(reg, []).append((op, mask))
            pressure = max(pressure, len(live_regs))

        # Baseline: every operand takes one whole 32-bit register; pressure
        # is the max number simultaneously live.
        events = sorted(
            [(o.start, 1) for o in ops_sorted]
            + [(o.end, -1) for o in ops_sorted]
        )
        base, cur = 0, 0
        for _, d in events:
            cur += d
            base = max(base, cur)

        return Allocation(
            entries=entries,
            register_pressure=pressure,
            registers_used=next_reg,
            total_slices=sum(o.slices for o in ops_sorted),
            baseline_pressure=base,
            split_count=split_count,
        )


def pack_operand_table(entries: Sequence[IndirectionEntry]) -> List[int]:
    """Emit the kernel's indirection-table image (one 32-bit word/entry)."""
    return [e.encode() for e in entries]


class PoolExhausted(RuntimeError):
    """Raised when an allocation or reservation exceeds pool capacity."""


class KVPagePool:
    """Fixed physical file of KV pages handed out to logical requests:
    logical position ``p`` of a request lives in physical page
    ``table[p // page_size]`` at row ``p % page_size``."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1:
            raise ValueError(f"need at least 1 page, got {n_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: Deque[int] = collections.deque(range(1, n_pages + 1))
        self._refcount: Dict[int, int] = {}
        self._reserved = 0
        self.peak_used = 0
        # prefix-sharing registry and hit accounting
        self._registry: Dict[bytes, int] = {}
        self._page_key: Dict[int, bytes] = {}
        self.prefix_hits = 0
        self.prefix_queries = 0
        # monotone lifecycle counts ("evict" = a last free returning the
        # page to the pool), mirrored into the engine's snapshot;
        # ``on_event(name, **attrs)`` is an optional hook (the engine
        # wires its tracer's ``event``)
        self.events: Dict[str, int] = {
            "alloc": 0, "free": 0, "retain": 0, "evict": 0,
            "reserve": 0, "release": 0,
        }
        self.on_event: Optional[Callable[..., object]] = None

    def _event(self, name: str, count: int = 1, **attrs) -> None:
        self.events[name] += count
        if self.on_event is not None:
            self.on_event(f"kv_pool.{name}", **attrs)

    # -- capacity accounting --------------------------------------------------
    @property
    def used(self) -> int:
        return len(self._refcount)

    @property
    def reserved(self) -> int:
        return self._reserved

    @property
    def free_pages(self) -> int:
        """Pages neither allocated nor promised: the admission budget."""
        return len(self._free) - self._reserved

    @property
    def utilization(self) -> float:
        return self.used / self.n_pages

    @property
    def peak_utilization(self) -> float:
        return self.peak_used / self.n_pages

    def can_reserve(self, n: int) -> bool:
        return 0 <= n <= self.free_pages

    def reserve(self, n: int) -> None:
        """Promise ``n`` pages to an admitted request (no page ids yet)."""
        if n < 0:
            raise ValueError(f"cannot reserve {n} pages")
        if n > self.free_pages:
            raise PoolExhausted(
                f"cannot reserve {n} pages: {self.free_pages} free of "
                f"{self.n_pages} ({self.used} used, {self._reserved} "
                "reserved)")
        self._reserved += n
        if n:
            self._event("reserve", n, pages=n, reserved=self._reserved)

    def release(self, n: int) -> None:
        """Return unallocated reservation (request finished early)."""
        if not 0 <= n <= self._reserved:
            raise ValueError(
                f"cannot release {n} of {self._reserved} reserved pages")
        self._reserved -= n
        if n:
            self._event("release", n, pages=n, reserved=self._reserved)

    # -- allocate / free ------------------------------------------------------
    def alloc(self, reserved: bool = False) -> int:
        """Hand out the lowest free page id. ``reserved=True`` draws down
        a prior ``reserve``; otherwise the page comes from the unpromised
        free bucket."""
        if reserved:
            if self._reserved < 1:
                raise ValueError("alloc(reserved=True) without reservation")
            self._reserved -= 1
        elif len(self._free) <= self._reserved:
            raise PoolExhausted(
                f"pool exhausted: {self.n_pages} pages, {self.used} used, "
                f"{self._reserved} reserved")
        page = self._free.popleft()
        self._refcount[page] = 1
        self.peak_used = max(self.peak_used, self.used)
        self._event("alloc", page=page, reserved=reserved)
        return page

    def retain(self, page: int) -> None:
        """Add a holder to an allocated (typically prefix-shared) page."""
        if page not in self._refcount:
            raise ValueError(f"retain of unallocated page {page}")
        self._refcount[page] += 1
        self._event("retain", page=page, refcount=self._refcount[page])

    def free(self, page: int) -> None:
        """Drop one holder; the last free returns the page to the pool
        and evicts its registry entry. Freeing an unallocated page (a
        double free included) raises."""
        rc = self._refcount.get(page)
        if rc is None:
            raise ValueError(
                f"free of unallocated page {page} (double free?)")
        if rc > 1:
            self._refcount[page] = rc - 1
            self._event("free", page=page, refcount=rc - 1)
            return
        del self._refcount[page]
        key = self._page_key.pop(page, None)
        if key is not None:
            self._registry.pop(key, None)
        self._free.append(page)
        self._event("free", page=page, refcount=0)
        self._event("evict", page=page, registered=key is not None)

    def refcount(self, page: int) -> int:
        return self._refcount.get(page, 0)

    # -- prefix-sharing registry ----------------------------------------------
    @staticmethod
    def chain_key(parent: Optional[bytes], tokens: Sequence[int]) -> bytes:
        """Key of a full page holding ``tokens`` whose predecessor chain
        hashed to ``parent`` (None for the first page). Two requests
        share a page iff their token prefixes agree page for page from
        position 0, which also pins the positions, so the cached rows
        (rope included) are bit-identical."""
        h = hashlib.blake2b(digest_size=16)
        h.update(parent if parent is not None else b"root")
        h.update(np.asarray(list(tokens), np.int64).tobytes())
        return h.digest()

    def lookup(self, key: bytes) -> Optional[int]:
        """Probe the registry; counts toward the prefix hit rate."""
        self.prefix_queries += 1
        page = self._registry.get(key)
        if page is not None:
            self.prefix_hits += 1
        return page

    def is_registered(self, key: bytes) -> bool:
        """Probe without counting (registration bookkeeping)."""
        return key in self._registry

    def register(self, key: bytes, page: int) -> None:
        """Publish an allocated page under its chain key, once its rows
        are written: a registered page is matchable at once, and a
        matcher reads it without recomputing. The entry lives as long as
        some holder does."""
        if page not in self._refcount:
            raise ValueError(f"register of unallocated page {page}")
        if key in self._registry:
            raise ValueError("chain key already registered")
        self._registry[key] = page
        self._page_key[page] = key

    @property
    def prefix_hit_rate(self) -> float:
        return self.prefix_hits / max(self.prefix_queries, 1)
