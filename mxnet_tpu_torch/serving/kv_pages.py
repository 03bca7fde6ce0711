"""Paged KV memory: the pool of fixed-size KV pages and the page-granular
prefix cache (counterpart of ``mxnet_tpu/serving/kv_pages.py``).

Each per-layer cache is a pool of ``page_size``-position pages, and each
slot holds a page table mapping its logical pages ``[0, Tmax/page_size)``
to physical page ids, so KV memory is bounded by live tokens rather than
``num_slots * Tmax`` (the PagedAttention design).  Page id ``num_pages``
(``scratch``) is the zero page: never allocated, refcounted, shared or
written; unassigned table entries point at it.  The device pool also
carries a trash page past it (see ``models/transformer.py``), which no
host structure ever names.

:class:`PagePool` refcounts its pages, so a whole-page prefix hit is a
table write plus a refcount, and preemption parks a victim's pages by
reference.  :class:`PagedPrefixCache` reuses the radix tree of
:mod:`.prefix_cache` over page lists claimed from the same pool; its
zero-reader entries are evicted, least recently used first, when an
allocation runs dry.  Scheduler-thread-only.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from .errors import ServingError
from .prefix_cache import PrefixCache, PrefixEntry, _Node

__all__ = ["PagePool", "PagedPrefixCache", "PagedPrefixEntry"]


class PagePool:
    """Free-list + refcount allocator over ``num_pages`` physical pages.
    A page returns to the free list when its last reader drops it."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1:
            raise ServingError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise ServingError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.scratch = self.num_pages
        self.reset()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def shared_count(self) -> int:
        """Pages with two readers or more."""
        return sum(1 for r in self._refs if r >= 2)

    def refs(self, pid: int) -> int:
        return self._refs[pid]

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` positions."""
        return (int(n_tokens) + self.page_size - 1) // self.page_size

    def alloc(self, n: int,
              reclaim: Optional[Callable[[int], int]] = None
              ) -> Optional[List[int]]:
        """Claim ``n`` pages (refcount 1 each), or None if the pool
        cannot cover them.  ``reclaim(k)`` (the prefix cache's eviction
        sweep) is called once with the shortfall before giving up."""
        if len(self._free) < n and reclaim is not None:
            reclaim(n - len(self._free))
        if len(self._free) < n:
            return None
        out = [self._free.pop() for _ in range(n)]
        for pid in out:
            self._refs[pid] = 1
        return out

    def ref(self, pid: int) -> int:
        """Add a reader (prefix sharing, park by reference)."""
        if not 0 <= pid < self.num_pages:
            raise ServingError(f"ref of non-pool page {pid}")
        if self._refs[pid] <= 0:
            raise ServingError(f"ref of free page {pid}")
        self._refs[pid] += 1
        return self._refs[pid]

    def unref(self, pid: int) -> bool:
        """Drop a reader; True iff this freed the page."""
        if not 0 <= pid < self.num_pages or self._refs[pid] <= 0:
            raise ServingError(f"unref of unreferenced page {pid}")
        self._refs[pid] -= 1
        if self._refs[pid] == 0:
            self._free.append(pid)
            return True
        return False

    def release(self, pids) -> List[int]:
        """Drop one reader from each of ``pids``; the ids that freed."""
        return [pid for pid in pids if self.unref(pid)]

    def mark_dirty(self, pids):
        """Record pages that hold non-finite K/V but are still
        referenced (the scrub-on-NaN path could not zero them); the
        engine scrubs them at their next claim."""
        self.dirty.update(int(p) for p in pids)

    def reset(self):
        """Forget every claim (paired with the engine zeroing its device
        caches)."""
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._refs: List[int] = [0] * self.num_pages
        # pages a non-finite victim wrote that another reader still
        # held at its release: scrubbed when next claimed
        self.dirty: set = set()

    def __repr__(self):
        return (f"PagePool(pages={self.num_pages}, "
                f"page_size={self.page_size}, free={len(self._free)}, "
                f"shared={self.shared_count})")


class PagedPrefixEntry(PrefixEntry):
    """One cached prefix mapped to pages: ``pages[i]`` holds positions
    ``[i*page_size, (i+1)*page_size)``; the last page may be partly
    valid (``length`` positions in all).  ``row`` stays -1."""

    __slots__ = ("pages",)

    def __init__(self, pages: Tuple[int, ...], length: int, node: _Node):
        super().__init__(-1, length, node)
        self.pages = tuple(pages)

    def __repr__(self):
        return (f"PagedPrefixEntry(pages={list(self.pages)}, "
                f"len={self.length}, refs={self.refs})")


class PagedPrefixCache(PrefixCache):
    """Radix tree over prompt prefixes mapping to shared pages.  An
    entry's pages are extra refcounts on pages a slot already filled, so
    an insert costs no copy; eviction is driven by :meth:`PagePool.alloc`
    pressure through :meth:`evict_pages`.

    ``demote_hook`` (the tiered prefix cache) is called with each
    zero-reader eviction victim before its pages are released: True
    downgrades the entry to a page-less tier-2 claim, which stays in the
    tree and can be promoted back, instead of detaching it.  The hook
    must not block: it snapshots and enqueues."""

    def __init__(self, pool: PagePool, min_tokens: int = 1,
                 demote_hook: Optional[Callable] = None):
        self.pool = pool
        self._free: List[int] = []     # no rows: ``free_rows`` is 0
        self.demote_hook = demote_hook
        self._init_tree(min_tokens)

    def evictable_pages(self) -> int:
        """Pages an eviction cascade could free now: pages whose every
        reader is a zero-reader entry (a page two evictable entries
        share frees once both go, so it counts)."""
        claims: dict = {}
        for e in self._entries:
            if e.refs == 0:
                for pid in e.pages:
                    claims[pid] = claims.get(pid, 0) + 1
        return sum(1 for pid, n in claims.items()
                   if self.pool.refs(pid) == n)

    def insert(self, tokens, pages=None, length: Optional[int] = None):
        """Register ``tokens`` as a prefix backed by ``pages`` (the donor
        slot's pages covering ``[0, len(tokens))``); the cache takes its
        own refcount on each.  None when the sequence is already cached
        (touched) or too short."""
        if pages is None:
            raise ServingError("PagedPrefixCache.insert needs the donor's "
                               "page list")
        if len(tokens) < self.min_tokens:
            return None
        n = len(tokens) if length is None else int(length)
        node = self._insert_node(tokens)
        if node.entry is not None:
            if node.entry.tier == 2:
                # a donor recomputed a family the tier holds only as a
                # claim: its live pages re-back the claim
                return self.upgrade(node.entry, pages, n)
            self._touch(node.entry)
            return None
        entry = PagedPrefixEntry(pages, n, node)
        for pid in entry.pages:
            self.pool.ref(pid)
        node.entry = entry
        self._entries.append(entry)
        self._touch(entry)
        return entry

    def upgrade(self, entry, pages, length: Optional[int] = None):
        """Re-back a tier-2 claim with device pages (a promotion's
        install, or a donor recomputing the family): the entry takes its
        own refcount on each page, as :meth:`insert` does, and returns
        to tier 1."""
        if entry.tier != 2 or entry.pages:
            raise ServingError(f"upgrade of non-tier-2 {entry!r}")
        entry.pages = tuple(pages)
        for pid in entry.pages:
            self.pool.ref(pid)
        entry.tier = 1
        if length is not None:
            entry.length = int(length)
        self._touch(entry)
        return entry

    def evict_pages(self, k: int) -> int:
        """Free at least ``k`` pages by evicting zero-reader entries in
        LRU order; returns how many freed.  A page still shared with a
        live slot only loses the entry's claim.  A victim the
        ``demote_hook`` accepts becomes a tier-2 claim (its pages freed
        all the same) instead of leaving the tree."""
        freed = 0
        while freed < k:
            victim = self._lru_victim()
            if victim is None:
                break
            demote = (self.demote_hook is not None
                      and self.demote_hook(victim))
            for pid in victim.pages:
                if self.pool.unref(pid):
                    freed += 1
            if demote:
                victim.pages = ()
                victim.tier = 2
            else:
                self._detach(victim)
            self.evictions += 1
        return freed

    def remove(self, entry):
        """Drop an entry, releasing its page claims."""
        for pid in entry.pages:
            self.pool.unref(pid)
        self._detach(entry)

    def reset(self):
        """Forget every mapping without touching refcounts (only called
        beside :meth:`PagePool.reset`)."""
        self._root = _Node((), None)
        self._entries = []

    def __repr__(self):
        return (f"PagedPrefixCache(entries={len(self._entries)}, "
                f"evictions={self.evictions})")
