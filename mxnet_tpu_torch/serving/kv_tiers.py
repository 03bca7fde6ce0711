"""Tiered KV prefix cache: integrity-verified host-RAM (and optional
disk) spill behind the paged prefix cache (counterpart of
``mxnet_tpu/serving/kv_tiers.py``).

The device page pool is tier 1.  When :class:`~.kv_pages.PagedPrefixCache`
eviction reclaims a zero-reader entry's pages under allocation pressure,
the engine may DEMOTE the entry instead of discarding it: the pages'
K/V is snapshotted on the device (a gather into fresh tensors — later
page reuse cannot tear it), handed to this module's bounded worker
thread, copied device→host through page-locked buffers OFF the
scheduler hot path, sealed with the integrity
layer's BLAKE2b tree digest (the exact :class:`~.migration.PrefixSeed`
discipline of checkpoint manifests and migration bundles), and stored
in a byte-bounded host-RAM LRU — tier 2.  The radix entry survives as a
page-less *tier-2 claim*; a later radix hit against it PROMOTES the
bundle back: verify-on-promote first (a rotted or bit-flipped spill is
a counted miss and the bundle is dropped/quarantined — it can never
reach a device page), then the scheduler writes the verified host arrays into the page pool,
in place, ahead of the request's first prefill chunk.

Hygiene invariants, in order of importance:

- **A poisoned page never round-trips.**  Demotion zeroes the tail
  positions past ``length`` in the bundle's last page (the only region
  a donor slot may have written beyond the cached prefix) and refuses
  any bundle containing non-finite values outright; the engine
  additionally never offers entries whose pages sit in the pool's
  NaN-``dirty`` set.  Promotion re-verifies the seal before any device
  byte moves.
- **Demotion never blocks admission.**  The scheduler only snapshots
  and enqueues; the device→host copy, hashing, and (optional) disk
  write all run on the single bounded worker.  A full job queue drops
  the demotion (counted) — the entry just evicts as it would without
  the tier.
- **Every failure degrades.**  Faults at ``serving.tier_demote`` /
  ``serving.tier_promote`` (per-engine ``@`` scoping), verify failures
  (``serving.tier_rot`` models the rot), host-pool exhaustion, and
  corrupt disk loads each degrade to a counted miss or drop; a streak
  of ``fault_limit`` consecutive failures self-disables the tier and
  the engine keeps serving from HBM exactly as before this module
  existed.

The optional disk tier (tier 3) holds bundles the host-RAM LRU
overflows: each is written atomically (tmp + ``os.replace``, the
checkpoint commit idiom) and a bundle that fails its
load or verify is QUARANTINED (renamed ``corrupt-*``, never deleted)
exactly like a rotted checkpoint step.  Its files are pickles of this
package's :class:`~.migration.PrefixSeed`, written and read by the port
alone (a reference tier file would import the reference package).

FIFO matters: demote and promote jobs share one queue, so a promotion
requested while the same key's demotion is still queued runs after it
and finds the bundle.  All cross-thread state is guarded by one named
lock (lockwitness-tracked); the scheduler-side radix/pool/table state
never crosses into this module.
"""
from __future__ import annotations

import os
import pickle
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as onp

from ..analysis.lockwitness import named_condition as _named_condition
from ..resilience.faults import inject as _inject, poison as _poison
from ..resilience.integrity import flip_array_bytes
from .errors import ServingError
from .migration import (HostCopy, MigrationDigestError, MigrationError,
                        PrefixSeed, seed_digest, verify_seed)

__all__ = ["HostKVTier", "TierHandle"]

#: bounded worker-queue depth: demotions beyond it are DROPPED (the
#: entry evicts as without the tier) — a spill storm must never build
#: an unbounded backlog of device snapshots pinned by queued jobs
TIER_QUEUE_DEPTH = 32


class TierHandle:
    """One in-flight promotion, handed to the scheduler at request time
    and resolved by the worker.  ``status`` moves ``pending`` →
    ``ready`` (``arrays`` holds the verified host arrays) or
    ``pending`` → ``failed``; reads/writes are guarded by the owning
    tier's lock (:meth:`HostKVTier.poll`)."""

    __slots__ = ("key", "status", "arrays", "length")

    def __init__(self, key: Tuple[int, ...]):
        self.key = key
        self.status = "pending"
        self.arrays: Optional[list] = None   # host arrays when ready
        self.length = 0

    def __repr__(self):
        return f"TierHandle(len={len(self.key)}, status={self.status})"


class _Bundle:
    """One stored tier-2 bundle (host RAM) or tier-3 stub (disk)."""

    __slots__ = ("seed", "nbytes", "path")

    def __init__(self, seed: Optional[PrefixSeed], nbytes: int,
                 path: Optional[str] = None):
        self.seed = seed          # None => spilled to disk at `path`
        self.nbytes = int(nbytes)
        self.path = path


class HostKVTier:
    """Byte-bounded host-RAM spill tier + its bounded worker thread.

    ``metrics`` duck-types :class:`~.metrics.ServingMetrics` (only
    ``count``/``mark`` are used) so the engine's ``tier_*`` counters
    export under the usual ``mxtpu_serving_<counter>_total`` family;
    a standalone tier (unit tests) counts into a private dict with the
    same keys."""

    def __init__(self, host_pool_bytes: int, *, page_size: int,
                 fault_limit: int = 3, disk_dir: Optional[str] = None,
                 scope: str = "serving", metrics=None,
                 kv_quant: Optional[str] = None):
        if host_pool_bytes <= 0:
            raise ServingError(
                f"host_pool_bytes must be > 0 to enable the tier, got "
                f"{host_pool_bytes}")
        if page_size < 1:
            raise ServingError(f"page_size must be >= 1, got {page_size}")
        self.host_pool_bytes = int(host_pool_bytes)
        self.page_size = int(page_size)
        # the owning engine's KV storage arm: stamped on every sealed
        # seed and checked on promote, so a disk-tier seed from a run
        # with the other arm reads as a miss instead of installing
        # int8 codes where the engine expects fp payload (or scales
        # where it expects none)
        self.kv_quant = kv_quant
        self.fault_limit = max(1, int(fault_limit))
        self.disk_dir = disk_dir
        self.scope = scope
        self.metrics = metrics
        # optional resolve hook (the engine parks its scheduler loop
        # while every live slot waits on a promotion — this pokes it
        # awake the instant a handle resolves instead of a poll tick
        # later).  Called OUTSIDE the tier lock, from the worker.
        self.on_resolve = None
        self._counters: Dict[str, int] = {}
        # ONE condition guards everything cross-thread (store, job
        # queue, handles, fault streak): worker and scheduler only ever
        # exchange small host objects, so a single monitor keeps the
        # witness graph trivial and every notify legal
        self._cond = _named_condition(
            "serving.kv_tier", "host bundle store + worker job queue")
        # key (token tuple) -> _Bundle, LRU order (oldest first)
        self._store: "OrderedDict[Tuple[int, ...], _Bundle]" = OrderedDict()
        self._disk: Dict[Tuple[int, ...], str] = {}
        self._used_bytes = 0
        self._jobs: deque = deque()
        self._inflight_demotes: set = set()
        self._fault_streak = 0
        self._disabled = False
        self._stopping = False
        self._busy = False
        self._thread: Optional[threading.Thread] = None
        if disk_dir is not None:
            os.makedirs(disk_dir, exist_ok=True)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "HostKVTier":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name=f"kv-tier:{self.scope}", daemon=True)
            self._thread.start()
        return self

    def stop(self, timeout: float = 2.0):
        """Stop the worker; every still-queued promotion fails (the
        scheduler degrades those slots to recompute) and queued
        demotions drop — a stopping engine must not block on spills."""
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout)
            self._thread = None
        with self._cond:
            jobs, self._jobs = list(self._jobs), deque()
            self._inflight_demotes.clear()
        for job in jobs:
            if job[0] == "promote":
                self._resolve(job[2], None)

    def drain(self, timeout: float = 5.0) -> bool:
        """Test/bench helper: wait until the worker queue is empty and
        the worker idle.  True on success, False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cond:
                if not self._jobs and not self._busy:
                    return True
            time.sleep(0.002)
        return False

    # -------------------------------------------------------------- queries
    @property
    def enabled(self) -> bool:
        return not self._disabled  # raceguard: unguarded(atomic bool read; a one-cycle-stale read only delays the degradation by one admission)

    @property
    def used_bytes(self) -> int:
        return self._used_bytes  # raceguard: unguarded(gauge snapshot: atomic int read, staleness bounded by one scrape)

    def __len__(self) -> int:
        return len(self._store) + len(self._disk)  # raceguard: unguarded(gauge snapshot: len reads are atomic, staleness bounded by one scrape)

    def contains(self, key) -> bool:
        """Whether a promotion request for ``key`` could find a bundle:
        stored in RAM, spilled to disk, or still queued for demotion
        (FIFO guarantees the demote lands before the promote runs)."""
        key = tuple(int(t) for t in key)
        with self._cond:
            return (key in self._store or key in self._disk
                    or key in self._inflight_demotes)

    def snapshot(self) -> dict:
        with self._cond:
            return {"entries": len(self._store),
                    "disk_entries": len(self._disk),
                    "used_bytes": self._used_bytes,
                    "host_pool_bytes": self.host_pool_bytes,
                    "queued_jobs": len(self._jobs),
                    "fault_streak": self._fault_streak,
                    "disabled": self._disabled}

    # ------------------------------------------------------------- counting
    def _count(self, key: str, n: int = 1):
        # outside self._cond by convention: the metrics object has its
        # own lock and the witness graph stays a tree
        if self.metrics is not None:
            self.metrics.count(key, n)
        else:
            self._counters[key] = self._counters.get(key, 0) + n

    def counter(self, key: str) -> int:
        if self.metrics is not None:
            return self.metrics.counters.get(key, 0)
        return self._counters.get(key, 0)

    def _fault(self, counter: str):
        """One contained tier fault: count it and advance the streak —
        ``fault_limit`` CONSECUTIVE failures self-disable the tier (the
        engine then serves from HBM only, exactly as without it)."""
        disable = False
        with self._cond:
            self._fault_streak += 1
            if self._fault_streak >= self.fault_limit and not self._disabled:
                self._disabled = True
                disable = True
        self._count(counter)
        self._count("tier_faults")
        if disable and self.metrics is not None:
            self.metrics.mark("tier_disabled")

    def _clean(self):
        with self._cond:
            self._fault_streak = 0

    # ------------------------------------------------------- scheduler side
    def offer(self, key, dev_arrays: List, length: int) -> bool:
        """Scheduler-side demotion offer for an entry being evicted at
        zero readers: ``dev_arrays`` are per-leaf DEVICE gathers of the
        entry's pages (fresh tensors: page reuse after this call cannot
        tear them).  Returns True iff the entry should
        downgrade to a tier-2 claim (job accepted, or the key is
        already stored).  Never blocks: a full queue or an oversized
        bundle is a counted drop and the entry evicts as usual."""
        if self._disabled or self._stopping:  # raceguard: unguarded(advisory fast-path: a one-cycle-stale read only lets one extra offer through; the worker re-checks nothing it cannot absorb)
            return False
        key = tuple(int(t) for t in key)
        nbytes = int(sum(a.numel() * a.element_size() for a in dev_arrays))
        if nbytes > self.host_pool_bytes:
            self._count("tier_drops")
            return False
        with self._cond:
            if key in self._store or key in self._inflight_demotes:
                hit = key in self._store
                if hit:
                    self._store.move_to_end(key)
                return True
            if key in self._disk:
                return True
            if len(self._jobs) >= TIER_QUEUE_DEPTH:
                drop = True
            else:
                drop = False
                self._inflight_demotes.add(key)
                self._jobs.append(("demote", key, list(dev_arrays),
                                   int(length)))
            self._cond.notify_all()
        if drop:
            self._count("tier_drops")
            return False
        return True

    def request(self, key) -> Optional[TierHandle]:
        """Scheduler-side promotion request against a tier-2 claim.
        Returns a :class:`TierHandle` to poll (the worker's verify
        resolves it), or ``None`` when no bundle can back the
        claim (stale claim, disabled tier, full queue) — the caller
        prunes the claim and recomputes."""
        if self._disabled or self._stopping:  # raceguard: unguarded(advisory fast-path: a stale read degrades to one extra counted miss, never a wrong token)
            return None
        key = tuple(int(t) for t in key)
        handle = TierHandle(key)
        with self._cond:
            present = (key in self._store or key in self._disk
                       or key in self._inflight_demotes)
            if not present or len(self._jobs) >= TIER_QUEUE_DEPTH:
                present = False
            else:
                self._jobs.append(("promote", key, handle))
                self._cond.notify_all()
        if not present:
            self._count("tier_misses")
            return None
        self._count("tier_hits")
        return handle

    def poll(self, handle: TierHandle) -> Tuple[str, Optional[list]]:
        """Non-blocking scheduler-side check: ``("pending", None)``,
        ``("ready", host_arrays)``, or ``("failed", None)``."""
        with self._cond:
            return handle.status, handle.arrays

    def abandon(self, handle: TierHandle):
        """The scheduler gave up waiting (promotion timeout): count the
        miss; a late worker resolution is simply discarded."""
        self._count("tier_misses")

    def discard(self, key):
        """Drop any stored bundle for ``key`` (RAM and disk)."""
        key = tuple(int(t) for t in key)
        with self._cond:
            self._drop_locked(key)

    # ----------------------------------------------------------- worker side
    def _run(self):
        while True:
            with self._cond:
                while not self._jobs and not self._stopping:
                    self._cond.wait(0.05)
                if not self._jobs:
                    return                   # stopping and drained
                job = self._jobs.popleft()
                self._busy = True
            try:
                if job[0] == "demote":
                    self._do_demote(job[1], job[2], job[3])
                else:
                    self._do_promote(job[1], job[2])
            except Exception:
                # defensive: a worker-side bug is a tier fault, never a
                # dead worker with scheduler slots parked on its handles
                if job[0] == "promote":
                    self._resolve(job[2], None)
                    self._fault("tier_misses")
                else:
                    self._demote_done(job[1])
                    self._fault("tier_drops")
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def _demote_done(self, key):
        with self._cond:
            self._inflight_demotes.discard(key)

    def _do_demote(self, key, dev_arrays, length):
        """Device→host copy, tail scrub, finiteness gate, seal, store.
        Entirely off the scheduler thread — the engine already holds a
        functional device snapshot, so nothing here races page reuse."""
        try:
            _inject("serving.tier_demote", scope=self.scope)
            arrays = HostCopy(dev_arrays).result()
        except Exception:
            self._demote_done(key)
            self._fault("tier_drops")
            return
        # scrub BEFORE sealing: positions >= length in the tail page
        # are the only region a donor slot may have written past the
        # cached prefix (possibly with the NaN the scrub-on-release
        # path could not reach while this entry still referenced the
        # page) — zero them so poison cannot round-trip through the
        # tier
        n_pages = int(arrays[0].shape[0]) if arrays else 0
        valid_tail = int(length) - (n_pages - 1) * self.page_size
        if 0 <= valid_tail < self.page_size:
            for a in arrays:
                a[-1, valid_tail:] = 0
        if any(not onp.isfinite(a).all() for a in arrays):
            # non-finite K/V inside the cached prefix itself: refuse
            # the bundle outright (hygiene, not a fault — the tier
            # stays enabled)
            self._demote_done(key)
            self._count("tier_drops")
            return
        seed = PrefixSeed(source=self.scope, layout="paged",
                          page_size=self.page_size, tokens=list(key),
                          length=int(length), arrays=arrays,
                          kv_quant=self.kv_quant)
        seed.digest = seed_digest(seed)
        # post-seal rot injection (state fault, never raises): flips
        # bytes in the sealed payload so verify-on-promote is what has
        # to catch it — exactly how real host-RAM rot would land
        if _poison("serving.tier_rot") is not None or \
                _poison(f"serving.tier_rot@{self.scope}") is not None:
            flip_array_bytes(seed.arrays[0])
        evicted = 0
        with self._cond:
            self._inflight_demotes.discard(key)
            if key not in self._store:
                self._store[key] = _Bundle(seed, seed.nbytes())
                self._used_bytes += seed.nbytes()
                evicted = self._shrink_locked()
        self._clean()
        self._count("tier_demotes")
        if evicted:
            self._count("tier_evictions", evicted)

    def _shrink_locked(self) -> int:  # guarded-by: _cond
        """LRU-evict host bundles past the byte budget (lock held);
        with a disk tier each victim spills atomically instead of
        dying.  Returns the eviction count (counted by the caller —
        outside the lock)."""
        evicted = 0
        while self._used_bytes > self.host_pool_bytes and self._store:
            key, rec = self._store.popitem(last=False)
            self._used_bytes -= rec.nbytes
            evicted += 1
            if self.disk_dir is not None and rec.seed is not None:
                self._spill_locked(key, rec)
        return evicted

    def _spill_locked(self, key, rec: _Bundle):
        """Atomic tier-3 write (tmp + ``os.replace``, the checkpoint
        commit idiom): a torn write can never shadow a good bundle, and
        a reader only ever sees fully-committed files."""
        path = os.path.join(self.disk_dir, f"{rec.seed.digest}.kvt")
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(rec.seed, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return
        self._disk[key] = path
        self._count("tier_disk_spills")

    def _load_disk(self, key) -> Optional[PrefixSeed]:
        """Tier-3 load; a torn/rotted file is QUARANTINED (renamed
        ``corrupt-*``, never deleted — forensics beat disk space) and
        reads as a miss.  Verification itself happens in the shared
        promote path."""
        with self._cond:
            path = self._disk.get(key)
        if path is None:
            return None
        try:
            with open(path, "rb") as f:
                seed = pickle.load(f)
            if not isinstance(seed, PrefixSeed):
                raise MigrationError(
                    f"disk tier file {path!r} does not hold a PrefixSeed")
            self._count("tier_disk_loads")
            return seed
        except Exception:
            self._quarantine(key, path)
            return None

    def _quarantine(self, key, path):
        with self._cond:
            self._disk.pop(key, None)
        try:
            d, base = os.path.split(path)
            os.replace(path, os.path.join(d, f"corrupt-{base}"))
        except OSError:
            pass
        self._count("tier_quarantines")

    def _do_promote(self, key, handle: TierHandle):
        with self._cond:
            rec = self._store.get(key)
            if rec is not None:
                self._store.move_to_end(key)
            seed = rec.seed if rec is not None else None
        if seed is None:
            seed = self._load_disk(key)
        try:
            _inject("serving.tier_promote", scope=self.scope)
            if seed is None:
                # stale claim (bundle LRU'd / quarantined between the
                # request and the job): a plain miss, not a fault
                self._resolve(handle, None)
                self._count("tier_misses")
                return
            verify_seed(seed)           # BEFORE any device byte moves
            if getattr(seed, "kv_quant", None) != self.kv_quant:
                # valid seal, wrong storage arm (a disk seed from a run
                # with the other kv_quant setting): treat like a
                # foreign schema — never reinterpret the payload
                raise MigrationError(
                    f"prefix seed kv_quant={getattr(seed, 'kv_quant', None)!r}"
                    f" != tier kv_quant={self.kv_quant!r}")
            # hand back the verified host arrays: the engine writes them
            # into its pool in place (its buffers are what the
            # programs captured)
            dev = seed.arrays
        except (MigrationDigestError, MigrationError):
            # the seal does not match the payload: host-RAM rot (or a
            # schema from another build).  The bundle is dropped — a
            # provably-corrupt spill must not be offered twice — and
            # the request recomputes.
            self._resolve(handle, None)
            with self._cond:
                path = self._disk.get(key)
                self._drop_locked(key, keep_disk=True)
            if path is not None:
                self._quarantine(key, path)
            self._fault("tier_verify_failures")
            self._count("tier_misses")
            return
        except Exception:
            self._resolve(handle, None)
            self._fault("tier_misses")
            return
        with self._cond:
            handle.status = "ready"
            handle.arrays = dev
            handle.length = seed.length
        self._notify_resolved()
        self._clean()
        self._count("tier_promotes")

    def _resolve(self, handle: TierHandle, arrays):
        with self._cond:
            handle.status = "failed" if arrays is None else "ready"
            handle.arrays = arrays
        self._notify_resolved()

    def _notify_resolved(self):
        cb = self.on_resolve     # raceguard: unguarded(hook is written once at engine construction, before the worker starts)
        if cb is not None:
            try:
                cb()
            except Exception:
                pass             # a wake hook must never hurt the tier

    def _drop_locked(self, key, keep_disk: bool = False):  # guarded-by: _cond
        rec = self._store.pop(key, None)
        if rec is not None:
            self._used_bytes -= rec.nbytes
        if not keep_disk:
            path = self._disk.pop(key, None)
            if path is not None:
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def __repr__(self):
        with self._cond:
            return (f"HostKVTier(entries={len(self._store)}, "
                    f"disk={len(self._disk)}, used={self._used_bytes}/"
                    f"{self.host_pool_bytes}B, "
                    f"disabled={self._disabled})")
