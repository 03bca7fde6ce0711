"""Host-side prefix cache: a radix tree over admitted prompt token
sequences mapping matched prefixes to cached K/V (counterpart of
``mxnet_tpu/serving/prefix_cache.py``).

A token's K/V depends only on the tokens before it, so two prompts that
share a prefix of length L share the K/V of positions ``[0, L)``
exactly.  In the dense layout the cache reserves a pool of rows past
the slots and the scratch row (``[S+1, S+1+P)`` of every per-layer
cache); a request whose prompt extends a cached prefix copies those
positions from the pool row into its slot row and prefills only the
suffix.  The paged layout (:class:`~.kv_pages.PagedPrefixCache`) shares
pages instead and reuses this tree.

Any prefix of a cached sequence is usable: ``lookup`` returns the
longest common prefix between the query and any cached sequence.
Entries are evicted least-recently-used under pool pressure, and only
at zero readers: the engine pins a source entry from lookup until the
request's prefill completes.  Scheduler-thread-only, like
:class:`~.kv_slots.SlotAllocator`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .errors import ServingError

__all__ = ["PrefixCache", "PrefixEntry"]


class _Node:
    """One radix-tree node.  ``edge`` is the token run from the parent
    (path compression); ``children`` keys on the first token of each
    child's edge; ``entry`` is set iff a cached sequence ends here."""

    __slots__ = ("edge", "children", "entry", "parent")

    def __init__(self, edge: Tuple[int, ...], parent: Optional["_Node"]):
        self.edge = edge
        self.children: Dict[int, "_Node"] = {}
        self.entry: Optional["PrefixEntry"] = None
        self.parent = parent


class PrefixEntry:
    """One cached prefix: pool row ``row`` holds K/V for positions
    ``[0, length)`` of the sequence spelled by the tree path."""

    __slots__ = ("row", "length", "refs", "last_used", "node")

    def __init__(self, row: int, length: int, node: _Node):
        self.row = row
        self.length = length
        self.refs = 0           # in-flight readers (engine pin/unpin)
        self.last_used = 0      # LRU tick, monotone per cache
        self.node = node

    def __repr__(self):
        return (f"PrefixEntry(row={self.row}, len={self.length}, "
                f"refs={self.refs})")


class PrefixCache:
    """Radix tree + pool-row free list.  ``row_base`` is the absolute
    cache row of pool row 0 (``num_slots + 1`` in the engine's layout);
    ``lookup``/``insert`` speak absolute rows."""

    def __init__(self, pool_rows: int, row_base: int, min_tokens: int = 1):
        if pool_rows < 1:
            raise ServingError(f"pool_rows must be >= 1, got {pool_rows}")
        self.pool_rows = int(pool_rows)
        self.row_base = int(row_base)
        self._init_tree(min_tokens)
        self._free: List[int] = self._all_rows()

    def _all_rows(self) -> List[int]:
        return list(range(self.row_base + self.pool_rows - 1,
                          self.row_base - 1, -1))

    def _init_tree(self, min_tokens: int):
        """The radix-tree + LRU state shared with the paged cache."""
        self.min_tokens = max(1, int(min_tokens))
        self.evictions = 0      # lifetime counter
        self._root = _Node((), None)
        self._entries: List[PrefixEntry] = []
        self._tick = 0

    # ------------------------------------------------------------- queries
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def free_rows(self) -> int:
        return len(self._free)

    def lookup(self, tokens) -> Optional[Tuple[int, PrefixEntry]]:
        """Longest common prefix between ``tokens`` and any cached
        sequence: ``(match_len, entry)`` where the entry holds valid K/V
        for at least ``[0, match_len)``, or None.  Touches the entry."""
        node, depth = self._walk(tokens)
        if depth < self.min_tokens:
            return None
        entry = self._any_entry(node)
        if entry is None:
            return None
        self._touch(entry)
        return min(depth, entry.length), entry

    def _walk(self, tokens) -> Tuple[_Node, int]:
        """Descend as far as ``tokens`` matches; a partial-edge match
        counts (every entry below that edge spells the same tokens)."""
        node, depth, n = self._root, 0, len(tokens)
        while depth < n:
            child = node.children.get(int(tokens[depth]))
            if child is None:
                break
            edge, m = child.edge, 0
            while m < len(edge) and depth + m < n \
                    and edge[m] == int(tokens[depth + m]):
                m += 1
            depth += m
            node = child
            if m < len(edge):
                break
        return node, depth

    def _any_entry(self, node: _Node) -> Optional[PrefixEntry]:
        """The most recently used entry at or below ``node``."""
        best, stack = None, [node]
        while stack:
            cur = stack.pop()
            if cur.entry is not None and \
                    (best is None or cur.entry.last_used > best.last_used):
                best = cur.entry
            stack.extend(cur.children.values())
        return best

    def _touch(self, entry: PrefixEntry):
        self._tick += 1
        entry.last_used = self._tick

    # ------------------------------------------------------------ refcounts
    def pin(self, entry: PrefixEntry):
        entry.refs += 1

    def unpin(self, entry: PrefixEntry):
        if entry.refs <= 0:
            raise ServingError(f"unpin of unpinned {entry!r}")
        entry.refs -= 1

    # -------------------------------------------------------------- insert
    def insert(self, tokens) -> Optional[PrefixEntry]:
        """Register ``tokens`` and reserve a pool row for them; the
        caller copies K/V ``[0, len(tokens))`` into ``entry.row`` (and
        removes the entry if it cannot).  None when the sequence is
        already cached (touched instead), too short, or every row is
        pinned."""
        if len(tokens) < self.min_tokens:
            return None
        node = self._insert_node(tokens)
        if node.entry is not None:
            self._touch(node.entry)
            return None
        row = self._alloc_row()
        if row is None:
            self._prune(node)      # a refused insert leaves no dead node
            return None
        entry = PrefixEntry(row, len(tokens), node)
        node.entry = entry
        self._entries.append(entry)
        self._touch(entry)
        return entry

    def _insert_node(self, tokens) -> _Node:
        """Walk, splitting edges at divergence, until a node spelling
        exactly ``tokens`` exists."""
        node, i, n = self._root, 0, len(tokens)
        while i < n:
            child = node.children.get(int(tokens[i]))
            if child is None:
                leaf = _Node(tuple(int(t) for t in tokens[i:]), node)
                node.children[int(tokens[i])] = leaf
                return leaf
            edge, m = child.edge, 0
            while m < len(edge) and i + m < n \
                    and edge[m] == int(tokens[i + m]):
                m += 1
            if m == len(edge):
                node, i = child, i + m
                continue
            mid = _Node(edge[:m], node)
            node.children[edge[0]] = mid
            child.edge = edge[m:]
            child.parent = mid
            mid.children[child.edge[0]] = child
            if i + m == n:
                return mid
            node, i = mid, i + m
        return node

    def _lru_victim(self) -> Optional[PrefixEntry]:
        """The least-recently-used zero-reader entry, or None:
        the one eviction policy of the dense rows and the paged sweep."""
        victim = None
        for e in self._entries:
            if e.refs == 0 and \
                    (victim is None or e.last_used < victim.last_used):
                victim = e
        return victim

    def _alloc_row(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        victim = self._lru_victim()
        if victim is None:
            return None
        row = victim.row
        self._detach(victim)
        self.evictions += 1
        return row

    # ------------------------------------------------------------- removal
    def remove(self, entry: PrefixEntry):
        """Drop an entry and return its row (a failed insert copy)."""
        self._detach(entry)
        self._free.append(entry.row)

    def _detach(self, entry: PrefixEntry):
        self._entries.remove(entry)
        entry.node.entry = None
        self._prune(entry.node)

    def _prune(self, node: _Node):
        """Drop dead leaves so the tree does not grow without bound."""
        while node.parent is not None and node.entry is None \
                and not node.children:
            parent = node.parent
            del parent.children[node.edge[0]]
            node = parent

    def reset(self):
        """Forget everything (the engine dropped its device caches)."""
        self._free = self._all_rows()
        self._root = _Node((), None)
        self._entries = []

    def __repr__(self):
        return (f"PrefixCache(rows={self.pool_rows}, "
                f"entries={len(self._entries)}, free={len(self._free)}, "
                f"evictions={self.evictions})")
