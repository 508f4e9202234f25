"""Host-side paged KV-cache management: refcounted block pool + per-slot tables.

The serving engine's paged mode replaces the contiguous ``(max_slots, max_len,
...)`` KV pytree with a device-resident pool of fixed-size pages plus a
per-slot *block table* of physical page indices.  This module is the host
brain of that layout; a copy of the JAX package's module, numpy only — the
engine owns the device tensors and asks the allocator which page goes where.

Why paging: batch prompting amortizes the shared system prompt in dollars
(every query in a batch rides one prefix); paging amortizes it in *memory*.
Sibling requests admitted together map their common-prefix pages onto the
same physical pages (refcount > 1), and a slot only gets a private copy of a
shared page at the moment it first needs to write into one — copy-on-write,
triggered exactly when decode appends into a partially-filled shared boundary
page.  A retired slot returns only the pages nobody else still references.

Two layers:

* :class:`BlockAllocator` — the refcounted free-list.  ``alloc`` / ``share``
  / ``fork`` (CoW) / ``release``, with hard failures on double-free and
  over-release, and the occupancy counters the serving plane reports
  (pages used / shared / CoW forks / peak).  Pure bookkeeping: this is the
  object the property-based tests drive.
* :class:`PagedCacheManager` — per-slot page lists + the ``(max_slots,
  pages_per_slot)`` int32 block table (sentinel ``n_pages`` marks unmapped
  entries; device writes to a sentinel are dropped, reads are masked).

Sizing: ``n_pages = max_slots * ceil(max_len / page_size)`` is sufficient by
construction — sharing only ever *reduces* distinct pages, and a CoW fork
requires a shared page, which implies at least one page of headroom.  The
allocator therefore never needs eviction.
"""
from __future__ import annotations

import numpy as np

__all__ = ["OutOfPages", "BlockAllocator", "PagedCacheManager"]


class OutOfPages(RuntimeError):
    """The pool has no free page (cannot happen with default sizing)."""


class BlockAllocator:
    """Refcounted fixed-size page pool (host bookkeeping only)."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages <= 0 or page_size <= 0:
            raise ValueError(f"need positive pool: n_pages={n_pages} "
                             f"page_size={page_size}")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # LIFO free list: recently freed pages are re-used first (their old
        # contents are dead — every consumer masks reads beyond ``len``)
        self._free: list[int] = list(range(self.n_pages - 1, -1, -1))
        self._ref = np.zeros(self.n_pages, np.int32)
        # lifetime counters (telemetry + tests)
        self.n_allocs = 0          # fresh pages handed out (fork included)
        self.n_shares = 0          # refcount bumps from prefix sharing
        self.n_forks = 0           # CoW forks performed
        self.n_frees = 0           # pages fully returned to the free list
        self.peak_pages = 0        # high-water mark of pages_in_use

    # ---- queries ------------------------------------------------------
    @property
    def pages_in_use(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_shared(self) -> int:
        """Pages currently referenced by more than one table entry."""
        return int((self._ref > 1).sum())

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    # ---- transitions --------------------------------------------------
    def alloc(self) -> int:
        if not self._free:
            raise OutOfPages(f"all {self.n_pages} pages in use")
        page = self._free.pop()
        assert self._ref[page] == 0, f"free page {page} had refcount {self._ref[page]}"
        self._ref[page] = 1
        self.n_allocs += 1
        self.peak_pages = max(self.peak_pages, self.pages_in_use)
        return page

    def alloc_n(self, n: int) -> list[int]:
        return [self.alloc() for _ in range(n)]

    def share(self, page: int) -> int:
        """One more table entry references ``page``; returns it for chaining."""
        if self._ref[page] <= 0:
            raise ValueError(f"cannot share unreferenced page {page}")
        self._ref[page] += 1
        self.n_shares += 1
        return page

    def fork(self, page: int) -> int:
        """Copy-on-write: detach one reference of shared ``page`` onto a fresh
        private page.  The caller owns copying the device contents and
        repointing its table entry; the remaining sharers keep ``page``."""
        if self._ref[page] < 2:
            raise ValueError(f"fork of non-shared page {page} "
                             f"(refcount {self._ref[page]})")
        new = self.alloc()
        self._ref[page] -= 1
        self.n_forks += 1
        return new

    def release(self, page: int) -> bool:
        """Drop one reference; returns True iff the page went back to the
        free list (refcount hit zero)."""
        if self._ref[page] <= 0:
            raise ValueError(f"double free of page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
            self.n_frees += 1
            return True
        return False

    # ---- invariants ---------------------------------------------------
    def check(self, tables=None) -> None:
        """Assert internal consistency (tests call this after every step).

        ``tables``: optional iterable of page-index lists (one per live slot);
        when given, every refcount must equal the number of table references.
        """
        assert (self._ref >= 0).all(), "negative refcount"
        free_set = set(self._free)
        assert len(free_set) == len(self._free), "duplicate page in free list"
        for p in self._free:
            assert self._ref[p] == 0, f"free page {p} has refcount {self._ref[p]}"
        in_use = {p for p in range(self.n_pages) if self._ref[p] > 0}
        assert not (in_use & free_set), "page both free and referenced"
        assert self.pages_in_use <= self.n_pages
        if tables is not None:
            want = np.zeros(self.n_pages, np.int32)
            for pages in tables:
                for p in pages:
                    want[p] += 1
            assert (want == self._ref).all(), (
                f"refcounts {self._ref.tolist()} != table references "
                f"{want.tolist()}")


class PagedCacheManager:
    """Per-slot block tables over one :class:`BlockAllocator`.

    The table is a host numpy array mirrored to the device each decode
    dispatch (``max_slots × pages_per_slot`` int32 — trivially small).  The
    sentinel value ``n_pages`` marks unmapped entries: device writes to them
    are dropped and reads of them are masked.
    """

    def __init__(self, max_slots: int, max_len: int, page_size: int,
                 n_pages: int | None = None):
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.pages_per_slot = -(-self.max_len // self.page_size)   # ceil
        if n_pages is None:
            n_pages = self.max_slots * self.pages_per_slot
        self.alloc = BlockAllocator(n_pages, page_size)
        self.slot_pages: list[list[int]] = [[] for _ in range(self.max_slots)]
        self.table = np.full((self.max_slots, self.pages_per_slot),
                             self.alloc.n_pages, np.int32)

    # ---- slot lifecycle ----------------------------------------------
    def release_slot(self, slot: int) -> int:
        """Return the slot's references; frees exactly the pages no other
        slot still shares.  Returns how many pages actually went free."""
        freed = sum(self.alloc.release(p) for p in self.slot_pages[slot])
        self.slot_pages[slot] = []
        self.table[slot, :] = self.alloc.n_pages
        return freed

    def map_slot(self, slot: int, pages: list[int]) -> None:
        """Point ``slot``'s table at ``pages`` (already alloc'd/shared)."""
        assert len(pages) <= self.pages_per_slot
        self.slot_pages[slot] = list(pages)
        self.table[slot, :] = self.alloc.n_pages
        self.table[slot, :len(pages)] = pages

    def extend_slot(self, slot: int, n_pages_total: int) -> list[int]:
        """Grow the slot's table to ``n_pages_total`` pages; returns the
        freshly allocated (private) pages."""
        pages = self.slot_pages[slot]
        new = []
        while len(pages) < min(n_pages_total, self.pages_per_slot):
            p = self.alloc.alloc()
            self.table[slot, len(pages)] = p
            pages.append(p)
            new.append(p)
        return new

    def truncate_slot(self, slot: int, n_tokens: int) -> int:
        """Shrink ``slot``'s table to cover exactly ``n_tokens`` positions,
        releasing every page past ``ceil(n_tokens / page_size)`` — the
        speculative-decode rollback: a rejected draft suffix disappears by
        dropping table references, never by copying KV bytes.  Returns how
        many pages actually went back to the free list (shared pages only
        drop a reference)."""
        keep = -(-n_tokens // self.page_size) if n_tokens > 0 else 0
        pages = self.slot_pages[slot]
        freed = 0
        while len(pages) > keep:
            p = pages.pop()
            freed += self.alloc.release(p)
            self.table[slot, len(pages)] = self.alloc.n_pages
        return freed

    def fork_for_write(self, slot: int, first_pos: int, last_pos: int):
        """Make every page covering positions ``[first_pos, last_pos)`` of
        ``slot`` private, forking shared ones.  Returns ``(src, dst)`` page
        lists for the device copy (empty when nothing was shared)."""
        pages = self.slot_pages[slot]
        lo = first_pos // self.page_size
        hi = min(-(-last_pos // self.page_size), len(pages))
        src, dst = [], []
        for j in range(lo, hi):
            if self.alloc.refcount(pages[j]) > 1:
                new = self.alloc.fork(pages[j])
                src.append(pages[j])
                dst.append(new)
                pages[j] = new
                self.table[slot, j] = new
        return src, dst

    # ---- telemetry ----------------------------------------------------
    def occupancy(self) -> dict:
        a = self.alloc
        return {
            "n_pages": a.n_pages, "page_size": a.page_size,
            "pages_used": a.pages_in_use, "pages_shared": a.pages_shared,
            "peak_pages": a.peak_pages, "cow_forks": a.n_forks,
            "prefix_shares": a.n_shares,
        }
