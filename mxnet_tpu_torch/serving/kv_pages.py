"""Paged KV memory: the pool of fixed-size KV pages (counterpart of
``mxnet_tpu/serving/kv_pages.py``, ``PagePool`` only — the paged prefix
cache is not ported yet).

Each per-layer cache is a pool of ``page_size``-position pages, and each
slot holds a page table mapping its logical pages ``[0, Tmax/page_size)``
to physical page ids, so KV memory is bounded by live tokens rather than
``num_slots * Tmax`` (the PagedAttention design).  Page id ``num_pages``
(``scratch``) is the zero page: never allocated and never written;
unassigned table entries point at it.  The device pool also carries a
trash page past it (see ``models/transformer.py``).
"""
from __future__ import annotations

from typing import List, Optional

from .errors import ServingError

__all__ = ["PagePool"]


class PagePool:
    """Free-list + refcount allocator over ``num_pages`` physical pages.
    Scheduler-thread-only."""

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

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` positions."""
        return (int(n_tokens) + self.page_size - 1) // self.page_size

    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` pages (refcount 1 each), or None if too few are
        free."""
        if len(self._free) < n:
            return None
        out = [self._free.pop() for _ in range(n)]
        for pid in out:
            self._refs[pid] = 1
        return out

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

    def reset(self):
        """Forget every claim (paired with the engine dropping its device
        caches)."""
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._refs: List[int] = [0] * self.num_pages

    def __repr__(self):
        return (f"PagePool(pages={self.num_pages}, "
                f"page_size={self.page_size}, free={len(self._free)})")
