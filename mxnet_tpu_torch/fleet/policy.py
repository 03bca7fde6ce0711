"""Routing policy for the fleet router: prefix affinity + rendezvous
hashing + least-loaded fallback.

Counterpart of ``mxnet_tpu/fleet/policy.py``: the same names, options,
counters, lock sites and fault sites, over the port's engines.

The point of affinity routing is to MULTIPLY the single-engine prefix
cache (docs/serving.md) across replicas: requests that share a system
prompt should land on the replica that already holds that prompt's K/V
in its prefix pool, instead of every replica paying the full prefill
once per prompt family.  Three pieces:

- **Affinity key** (:meth:`RoutingPolicy.affinity_key`): the router
  keeps its own host-side radix tree over routed prompts — the SAME
  :class:`~mxnet_tpu_torch.serving.prefix_cache.PrefixCache` structure the
  engine uses, so the notion of "prefix" is identical on both sides —
  and keys each request by the longest prefix it shares with earlier
  traffic.  The matched length is CAPPED at ``affinity_window`` tokens:
  a prompt family's FIRST request (no match yet, keyed by its head) and
  every later one (full shared-prefix match, capped back to the head)
  then agree on one key, so the whole family converges on one replica
  instead of the opener landing elsewhere.  Families whose shared
  prefix is shorter than the window still key at the true sharing
  boundary — that is what the radix walk buys over a fixed-width hash.

- **Rendezvous (HRW) hashing** (:func:`rendezvous_rank`): each
  (key, replica) pair gets a deterministic score; the request prefers
  replicas in descending score order.  Adding or removing one replica
  remaps only ~1/N of the keyspace — every key whose winner survives
  keeps its winner — which is exactly the property a prefix-cache-
  affine router needs across restarts and drains (consistent-hash
  rings buy the same property with more machinery).

- **Least-loaded fallback**: when a request has no usable prefix (short
  prompt, forward mode) or its affinity target is saturated, replicas
  are ordered by instantaneous load — queue depth plus active slots,
  read from the engine's own gauges — so spill traffic spreads instead
  of piling behind the hot replica.

The tree is caller-thread shared state (``submit`` runs on arbitrary
threads), so unlike the engine-internal ``PrefixCache`` uses, every
tree op here is lock-guarded.
"""
from __future__ import annotations

import hashlib
import threading
from typing import List, Optional, Sequence

from ..analysis.lockwitness import named_lock as _named_lock
from ..serving.errors import ServingError
from ..serving.prefix_cache import PrefixCache

__all__ = ["RoutingPolicy", "rendezvous_rank", "rendezvous_hash"]


def _score(key: bytes, name: str) -> int:
    """Deterministic 64-bit HRW score for (key, replica).  blake2b, not
    ``hash()``: Python string hashing is salted per process, and a
    router restarted on another host must rank replicas identically or
    every cached prefix goes cold on failover."""
    h = hashlib.blake2b(digest_size=8)
    h.update(key)
    h.update(b"\x00")
    h.update(name.encode("utf-8"))
    return int.from_bytes(h.digest(), "big")


def rendezvous_rank(key: bytes, names: Sequence[str]) -> List[str]:
    """Replica names in descending highest-random-weight order for
    ``key``.  Ties (only possible for duplicate names) break on the
    name itself so the order is total and deterministic."""
    return sorted(names, key=lambda n: (_score(key, n), n), reverse=True)


def rendezvous_hash(key: bytes, names: Sequence[str]) -> str:
    """The HRW winner for ``key`` among ``names``."""
    if not names:
        raise ServingError("rendezvous_hash needs at least one name")
    return rendezvous_rank(key, names)[0]


class RoutingPolicy:
    """Affinity-key computation over a bounded radix tracker.

    Parameters
    ----------
    min_tokens : shortest prefix worth affinity-routing on — mirrors the
        engine's ``prefix_min_tokens`` (a shorter match would not be
        cached replica-side either).
    affinity_window : cap on the affinity key length in tokens.  The cap
        is what makes a prompt family's first request and its followers
        (whose radix matches differ: nothing vs everything) key
        identically; it also bounds hashing cost per route.
    tracker_entries : radix-tracker capacity (LRU beyond it) — bounds
        host memory for long-running routers; an evicted family simply
        re-keys from its head, same as a fresh one.
    """

    def __init__(self, min_tokens: int = 4, affinity_window: int = 32,
                 tracker_entries: int = 512):
        self.min_tokens = max(1, int(min_tokens))
        self.affinity_window = max(self.min_tokens, int(affinity_window))
        # row_base=0: the tracker never touches device rows, the pool
        # indices are just LRU tickets bounding the tree
        self._tree = PrefixCache(int(tracker_entries), row_base=0,
                                 min_tokens=self.min_tokens)
        self._lock = _named_lock("fleet.policy.tracker",
                                 "router-side prefix radix tracker")

    def affinity_key(self, tokens) -> Optional[bytes]:
        """The affinity key for a prompt, or ``None`` when it is too
        short to bother.  Looks up the longest shared prefix with
        earlier routed traffic, caps it at the window, and records the
        prompt for later arrivals."""
        n = len(tokens)
        if n < self.min_tokens:
            return None
        with self._lock:
            hit = self._tree.lookup(tokens)
            match = hit[0] if hit is not None else 0
            # record AFTER lookup: a prompt must not match itself, or
            # every request would key at its own full length and no two
            # family members would ever agree
            self._tree.insert(tokens)
        if match >= self.min_tokens:
            key_len = min(match, self.affinity_window)
        else:
            key_len = min(n, self.affinity_window)
        return self._hash_head(tokens, key_len)

    def peek_key(self, tokens) -> Optional[bytes]:
        """The affinity key ``tokens`` WOULD get — without recording
        the prompt in the tracker.  The scale-down seeding path uses
        this to key exported prefix entries: the entry's tokens were
        already routed once (recording them again would be a no-op at
        best and, for a fresh tracker, would self-match later traffic
        at full length), so the peek computes the same key the family's
        followers carry while leaving the tracker untouched."""
        n = len(tokens)
        if n < self.min_tokens:
            return None
        with self._lock:
            hit = self._tree.lookup(tokens)
        match = hit[0] if hit is not None else 0
        if match >= self.min_tokens:
            key_len = min(match, self.affinity_window)
        else:
            key_len = min(n, self.affinity_window)
        return self._hash_head(tokens, key_len)

    @staticmethod
    def _hash_head(tokens, key_len: int) -> bytes:
        head = [int(t) for t in tokens[:key_len]]
        h = hashlib.blake2b(digest_size=16)
        h.update(",".join(map(str, head)).encode("ascii"))
        return h.digest()

    def rank(self, key: bytes, names: Sequence[str]) -> List[str]:
        return rendezvous_rank(key, names)

    def reset(self):
        with self._lock:
            self._tree.reset()

    def __len__(self):
        with self._lock:
            return len(self._tree)
