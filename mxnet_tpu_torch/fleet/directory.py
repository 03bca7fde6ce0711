"""Fleet-wide prefix/page directory (docs/fleet.md "Disaggregated
serving").

Counterpart of ``mxnet_tpu/fleet/directory.py``: the same names, options,
counters, lock sites and fault sites, over the port's engines.

The single-replica prefix cache (docs/serving.md) stops paying at the
replica boundary: a prompt family whose K/V pages live on replica A is
a full prefill on replica B.  The :class:`RoutingPolicy` radix tracker
already *keys* families consistently; this directory closes the loop
by remembering **where each family's KV currently resides** — a
bounded, lock-guarded map ``affinity key → (replica name, residency
tick)``.

Placement consults it first: a locate hit steers the request (or the
migrated decode half, in a disaggregated fleet) to the replica whose
pool actually holds the family's pages, ahead of the stateless HRW
rank.  Publishes happen wherever KV residency is CREATED — a routed
admission on a unified fleet, a successful ``adopt()`` on a
decode-role replica — so the directory tracks reality, not intent.

The directory is advisory, never authoritative: an entry can go stale
(the replica evicted the family under pool pressure, died, or was
rebuilt empty).  A stale hit degrades to exactly what no directory
would have done — a prefix miss on an otherwise fine replica — so
correctness never depends on it.  Replica death simply drops every
entry pointing at the corpse (:meth:`forget_replica`); rebuilt
replicas re-earn entries through fresh traffic.

Capacity is LRU-bounded like the tracker: an evicted family re-keys
from scratch, indistinguishable from a cold one.
"""
from __future__ import annotations

import collections
from typing import Dict, Optional

from ..analysis.lockwitness import named_lock as _named_lock

__all__ = ["FleetDirectory"]


class FleetDirectory:
    """Bounded LRU map: affinity key → replica residency."""

    def __init__(self, entries: int = 512):
        self.entries = max(1, int(entries))
        # OrderedDict as LRU: move_to_end on touch, popitem(last=False)
        # to evict the coldest family
        self._map: "collections.OrderedDict[bytes, str]" = \
            collections.OrderedDict()
        self._tick = 0               # publishes seen (residency age)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._lock = _named_lock("fleet.directory",
                                 "prefix-key -> replica residency map")

    def publish(self, key: Optional[bytes], replica: str) -> None:
        """Record that ``replica`` now holds ``key``'s KV (admission or
        adoption just landed there).  ``key=None`` (prompt too short to
        key) is a no-op.  Last writer wins — residency follows the most
        recent placement, which is where the freshest pages are."""
        if key is None:
            return
        with self._lock:
            self._tick += 1
            self._map[key] = replica
            self._map.move_to_end(key)
            while len(self._map) > self.entries:
                self._map.popitem(last=False)
                self.evictions += 1

    def locate(self, key: Optional[bytes]) -> Optional[str]:
        """Where does ``key``'s KV live?  Counts a hit/miss and
        LRU-touches the entry.  ``None`` for unkeyed prompts and
        unknown families."""
        if key is None:
            return None
        with self._lock:
            name = self._map.get(key)
            if name is None:
                self.misses += 1
                return None
            self.hits += 1
            self._map.move_to_end(key)
            return name

    def forget_replica(self, replica: str) -> int:
        """Drop every entry pointing at ``replica`` (death, rebuild,
        drain) — a corpse must not attract affinity traffic.  Returns
        the number of entries dropped."""
        with self._lock:
            dead = [k for k, v in self._map.items() if v == replica]
            for k in dead:
                del self._map[k]
            return len(dead)

    def reset(self) -> None:
        with self._lock:
            self._map.clear()
            self.hits = self.misses = self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            total = self.hits + self.misses
            return {"entries": len(self._map),
                    "capacity": self.entries,
                    "hits": self.hits,
                    "misses": self.misses,
                    "evictions": self.evictions,
                    "hit_rate": round(self.hits / total, 4)
                    if total else None}
