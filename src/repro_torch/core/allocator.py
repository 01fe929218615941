"""The KV page pool: fixed-size KV-cache pages handed out to requests.

Port of the serving half of ``repro.core.allocator`` (``KVPagePool``,
``PoolExhausted``, ``KVPagePool.chain_key``); the register-slice
allocator of the paper's Section 4.3 is not on the serving path and is
not ported. Host Python only: page ids, refcounts, reservations and a
prefix-hash registry. The device buffers indexed by the page ids belong
to the caller (``ServeEngine``'s paged decode state).

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
import hashlib
from typing import Callable, Deque, Dict, Optional, Sequence

import numpy as np


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
