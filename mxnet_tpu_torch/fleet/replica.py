"""One replica of the fleet: an :class:`InferenceEngine` plus the
health/lifecycle state the router places traffic by.

Counterpart of ``mxnet_tpu/fleet/replica.py``: the same names, options,
counters, lock sites and fault sites, over the port's engines.

A replica is always in exactly one state:

- ``HEALTHY`` — routable.  The monitor polls ``engine.health()``; the
  first not-live probe (scheduler died, watchdog condemned, crashed)
  moves it to ``DEAD``.
- ``SUSPECT`` — not routable, but alive: the gray-failure state
  (docs/integrity.md).  The router feeds every completion's latency
  into the handle's :class:`~mxnet_tpu_torch.resilience.integrity.LatencyTracker`;
  a replica whose EWMA *and* windowed p99 sit a configurable multiple
  above its peers' median — slow enough to hurt, healthy enough to keep
  passing ``health()`` — is ejected here.  Unlike ``DEAD`` the engine
  keeps running and FINISHES its in-flight work; new placement skips it
  exactly like a dead replica (so its HRW keyspace remaps ~1/N onto
  the healthy rest).  Re-admission rides the same probation/backoff
  ladder as deaths but WITHOUT a rebuild: when the window elapses the
  latency window is reset and the replica returns to ``HEALTHY`` — its
  warm caches intact, so re-admission costs zero compiles.  A SUSPECT
  that then fails ``health()`` goes ``DEAD`` normally.
- ``DEAD`` — not routable; sitting out a probation window.  The window
  starts at ``probation`` seconds and doubles per consecutive death
  (capped at ``probation_max``): a replica that crashes right back
  after every rebuild backs off instead of flapping traffic onto a
  poisoned host.  When the window elapses and the fleet has an engine
  ``factory``, the monitor REBUILDS the replica — a condemned engine
  can never be restarted (docs/resilience.md), re-admission is a fresh
  engine under the same replica name — optionally re-running
  ``warmup()`` so the newcomer never compiles on traffic.
- ``DRAINING`` — not routable; ``engine.stop(drain=True)`` in progress.
  Queued and in-flight requests on the replica finish; new traffic is
  steered away.  This is the rolling-restart building block.
- ``STOPPED`` — drained (or force-stopped); waiting for ``restart()``
  or fleet shutdown.

State transitions are guarded by the handle's lock; the engine
reference itself is swapped atomically on rebuild, so routing threads
reading ``handle.engine`` mid-readmission see either the corpse (whose
``submit`` raises typed — the router just tries the next candidate) or
the replacement, never a torn handle.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..analysis.lockwitness import named_lock as _named_lock
from ..resilience.integrity import LatencyTracker
from ..serving.overload import CircuitBreaker

__all__ = ["ReplicaHandle", "HEALTHY", "DEAD", "DRAINING", "STOPPED",
           "SUSPECT"]

HEALTHY = "healthy"
DEAD = "dead"
DRAINING = "draining"
STOPPED = "stopped"
SUSPECT = "suspect"


class ReplicaHandle:
    def __init__(self, name: str, engine, *,
                 factory: Optional[Callable] = None,
                 probation: float = 0.25,
                 probation_backoff: float = 2.0,
                 probation_max: float = 30.0,
                 restart_warmup: bool = True,
                 breaker: Optional[CircuitBreaker] = None,
                 latency_window: int = 64,
                 latency_alpha: float = 0.25):
        self.name = name
        self.engine = engine
        self.factory = factory
        self.probation = float(probation)
        self.probation_backoff = float(probation_backoff)
        self.probation_max = float(probation_max)
        self.restart_warmup = bool(restart_warmup)
        # retry-storm protection (docs/overload.md): consecutive sheds
        # / replica-level submit failures open the breaker and the
        # router stops offering this replica traffic for a cooldown —
        # the breaker OUTLIVES engine rebuilds (it gates the replica
        # slot, not one engine incarnation)
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        self.state = HEALTHY
        self.deaths = 0              # consecutive (resets on healthy probe)
        self.total_deaths = 0
        self.restarts = 0
        self.routed = 0              # requests placed here (router-counted)
        self.probation_until: Optional[float] = None
        self.last_error: Optional[str] = None
        # gray-failure defense (docs/integrity.md): the router feeds
        # per-completion latencies here; the monitor compares this
        # window against its peers' median and SUSPECT-ejects outliers
        self.latency = LatencyTracker(window=latency_window,
                                      alpha=latency_alpha)
        self.suspects = 0            # consecutive gray ejections (ladder)
        self.total_suspects = 0
        self.suspect_until: Optional[float] = None
        # set by the router's MANUAL drain()/rolling_restart() path and
        # cleared on restart()/replace(): the autoscaler must never
        # read a deliberately-draining replica as shrink headroom or
        # its (expectedly rising) queue as scale-up evidence
        self.manual_drain = False
        self._lock = _named_lock("fleet.replica",
                                 "replica lifecycle state")

    # ---------------------------------------------------------------- state
    @property
    def role(self) -> str:
        """Disaggregated-serving role (docs/fleet.md "Disaggregated
        serving") read off the live engine — a rebuild (same factory,
        same config) keeps it without the handle storing a copy that
        could drift from the engine's truth."""
        return getattr(self.engine, "role", "unified")  # raceguard: unguarded(engine ref is swapped atomically on rebuild; the factory rebuilds the same role)

    def can_prefill(self) -> bool:
        """May NEW requests be placed here?  Prefill-role and unified
        replicas take fresh traffic; decode-role replicas only receive
        work through adopt()."""
        return self.role in ("prefill", "unified")

    def can_decode(self) -> bool:
        """May migrated bundles be adopted here?"""
        return self.role in ("decode", "unified")

    def routable(self) -> bool:
        return self.state == HEALTHY  # raceguard: unguarded(placement hot path: atomic str read; a stale verdict is re-validated by the typed submit failure path)

    def load(self) -> int:
        """Instantaneous placement load: admission-queue depth plus
        leased KV slots — the same numbers the engine exports as the
        ``mxtpu_serving_queue_depth`` / ``mxtpu_serving_active_slots``
        registry gauges, read straight off the engine so routing never
        pays a full registry collect()."""
        eng = self.engine  # raceguard: unguarded(engine ref is swapped atomically on rebuild; a corpse read here fails typed and reroutes)
        try:
            q = len(eng._batcher)
            a = eng._alloc.active_count if eng._alloc is not None else 0
            return q + a
        except Exception:
            return 1 << 30           # unreadable replica sorts last

    def queue_depth(self) -> int:
        try:
            return len(self.engine._batcher)  # raceguard: unguarded(engine ref is swapped atomically on rebuild; a corpse read sorts the replica last)
        except Exception:
            return 1 << 30

    def saturated(self, spill_depth: int) -> bool:
        """The affinity-spill test: is this replica's queue deep enough
        that waiting behind it costs more than a prefix miss elsewhere?
        """
        return self.queue_depth() >= spill_depth

    # --------------------------------------------------------------- deaths
    def mark_dead(self, reason: str, now: Optional[float] = None) -> bool:
        """HEALTHY/SUSPECT → DEAD with a fresh probation window; returns
        whether this call made the transition (the monitor and a failing
        submit path may race to report the same corpse).  A SUSPECT that
        actually dies goes DEAD normally — gray ejection never shields a
        real corpse from the rebuild path."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self.state not in (HEALTHY, SUSPECT):
                return False
            self.state = DEAD
            self.deaths += 1
            self.total_deaths += 1
            self.last_error = reason
            self.suspect_until = None
            window = min(self.probation_max, self.probation *
                         self.probation_backoff ** (self.deaths - 1))
            self.probation_until = now + window
            return True

    def probe(self, now: Optional[float] = None) -> bool:
        """One monitor tick: returns True iff this probe transitioned
        the replica to DEAD.  A healthy probe resets the consecutive-
        death streak (the backoff ladder restarts).  SUSPECT replicas
        are probed too — slow is survivable, dead is not."""
        if self.state not in (HEALTHY, SUSPECT):  # raceguard: unguarded(monitor fast path: atomic str read; the transition re-checks under the lock in mark_dead)
            return False
        try:
            h = self.engine.health()  # raceguard: unguarded(engine ref is swapped atomically on rebuild; probing a corpse reports dead, which is correct)
            live = bool(h["live"])
            reason = h.get("crashed") or "scheduler not live"
        except Exception as e:            # a broken probe IS a dead replica
            live, reason = False, f"health() raised: {e!r}"
        if live:
            with self._lock:
                # the reset must not race a failing submit path's
                # locked mark_dead increment — a lost increment would
                # shorten the probation backoff ladder
                if self.state == HEALTHY:
                    self.deaths = 0
            return False
        return self.mark_dead(str(reason), now)

    # ----------------------------------------------------- gray failure
    def observe_latency(self, seconds: float) -> None:
        """One completed request's latency (router completion path)."""
        self.latency.observe(seconds)

    def mark_suspect(self, reason: str,
                     now: Optional[float] = None) -> bool:
        """HEALTHY → SUSPECT: stop offering this replica traffic but let
        it finish what it holds.  The suspension window rides the same
        probation/backoff ladder as deaths, keyed on CONSECUTIVE gray
        ejections, so a replica that is still slow on every re-admission
        backs off instead of flapping its keyspace."""
        now = time.monotonic() if now is None else now
        with self._lock:
            if self.state != HEALTHY:
                return False
            self.state = SUSPECT
            self.suspects += 1
            self.total_suspects += 1
            self.last_error = reason
            window = min(self.probation_max, self.probation *
                         self.probation_backoff ** (self.suspects - 1))
            self.suspect_until = now + window
            return True

    def due_for_unsuspect(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            # state and suspect_until move together under the lock;
            # reading them apart could see SUSPECT with a window that
            # another transition already cleared
            return (self.state == SUSPECT
                    and self.suspect_until is not None
                    and now >= self.suspect_until)

    def unsuspect(self) -> bool:
        """Suspension elapsed: return to HEALTHY with a RESET latency
        window — the replica is judged on fresh samples, not the storm
        that ejected it.  No rebuild, no re-warm: the engine never
        stopped, so its compiled programs and prefix cache are still
        warm and re-admission costs zero compiles on traffic."""
        with self._lock:
            if self.state != SUSPECT:
                return False
            self.state = HEALTHY
            self.suspect_until = None
        self.latency.reset()
        return True

    def due_for_readmission(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            # state and probation_until move together under the lock
            return (self.state == DEAD and self.factory is not None
                    and self.probation_until is not None
                    and now >= self.probation_until)

    def rebuild(self, abort: Optional[Callable[[], bool]] = None) -> bool:
        """Probation elapsed: build a fresh engine under this replica's
        name, start it (and re-warm unless ``restart_warmup=False`` —
        a re-admitted replica should not pay compiles on live traffic),
        and go HEALTHY.  A failed rebuild counts as another death and
        extends the backoff window.

        ``abort`` is polled around the (slow: warmup compiles) build:
        when it turns true — the fleet started shutting down mid-
        rebuild — the replacement engine is stopped instead of
        committed, so a stopped fleet can never resurrect a running
        replica."""
        if self.factory is None:
            return False
        # retire the corpse FIRST: a condemned/stopped engine releases
        # its claimed name, so the replacement reclaims the PLAIN name
        # and this replica's metric series keep their labels across
        # restarts instead of drifting to "<name>-2"
        try:
            self.engine.stop(drain=False, timeout=1.0)  # raceguard: unguarded(rebuild runs on the monitor thread, the only engine-ref writer, so its own read cannot race)
        except Exception:
            pass
        try:
            eng = self.factory(self.name)
            if eng._thread is None:
                eng.start()
            if self.restart_warmup:
                eng.warmup()
        except Exception as e:
            with self._lock:
                self.deaths += 1
                self.total_deaths += 1
                self.last_error = f"rebuild failed: {e!r}"
                window = min(self.probation_max, self.probation *
                             self.probation_backoff ** (self.deaths - 1))
                self.probation_until = time.monotonic() + window
            return False
        if abort is not None and abort():
            self._discard(eng)
            return False
        with self._lock:
            self.engine = eng
            self.state = HEALTHY
            self.restarts += 1
            self.probation_until = None
            self.suspect_until = None
        self.latency.reset()       # fresh engine, fresh evidence
        # a rebuilt replica starts with a CLOSED breaker: its fresh,
        # empty queue owes nothing to the corpse's shed streak
        self.breaker.record_success()
        if abort is not None and abort():
            # shutdown landed between the check above and the commit:
            # undo — the fleet's stop sweep may already have passed this
            # handle, so it must not stay HEALTHY with a live engine
            with self._lock:
                self.state = STOPPED
            self._discard(eng)
            return False
        return True

    def _discard(self, eng) -> None:
        try:
            eng.stop(drain=False, timeout=1.0)
        except Exception:
            pass

    def __repr__(self):
        return (f"ReplicaHandle({self.name!r}, "
                f"state={self.state}, "  # raceguard: unguarded(repr diagnostic: atomic reads, momentary staleness is harmless)
                f"deaths={self.total_deaths}, "  # raceguard: unguarded(repr diagnostic: atomic reads, momentary staleness is harmless)
                f"suspects={self.total_suspects}, "  # raceguard: unguarded(repr diagnostic: atomic reads, momentary staleness is harmless)
                f"restarts={self.restarts})")  # raceguard: unguarded(repr diagnostic: atomic reads, momentary staleness is harmless)
