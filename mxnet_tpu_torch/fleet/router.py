"""`FleetRouter` — the multi-replica front door.

Counterpart of ``mxnet_tpu/fleet/router.py``: host Python with the same
names, options, counters, lock sites and fault sites, over the port's
engines (which keep the reference's ``_thread``, ``_batcher`` and
``_alloc``).

One :class:`~mxnet_tpu_torch.serving.InferenceEngine` is not a fleet: heavy
traffic needs N replicas, and the router is the tier that coordinates
them while each replica keeps its single-engine semantics.  Callers
swap one import — the router exposes the same ``infer`` / ``submit`` /
``stats`` / ``stop`` surface as the engine — and get:

- **Prefix-affinity placement** (:mod:`.policy`): requests sharing a
  system prompt rendezvous-hash onto the replica whose prefix pool
  already holds that prompt's K/V, multiplying the single-engine TTFT
  win (docs/serving.md) across the fleet instead of paying one full
  prefill per replica per prompt family.  A saturated affinity target
  spills to the least-loaded healthy replica — a prefix hit is not
  worth queueing behind a hot spot.
- **Health-gated placement** (:mod:`.replica`): a monitor thread polls
  every replica's ``health()``; a dead/condemned replica stops taking
  traffic immediately and is re-admitted only after a probation window
  with exponential backoff — rebuilt fresh via the engine ``factory``
  (a condemned engine cannot be restarted) and re-warmed so it never
  compiles on live traffic.
- **Gray-failure ejection** (docs/integrity.md): binary liveness misses
  the replica that answers ``health()`` but serves 10x slow.  The
  router feeds each completion's latency into the owning replica's
  :class:`~mxnet_tpu_torch.resilience.integrity.LatencyTracker`; the monitor
  compares EWMA + windowed p99 against the median of its PEERS
  (self-excluded, so an outlier cannot inflate its own bar) and moves
  outliers (``gray_multiplier`` above that median, with
  ``gray_min_samples`` evidence) to ``SUSPECT`` — HRW-skipped like a
  dead replica but still finishing its in-flight work, re-admitted
  through the probation/backoff ladder WITHOUT a rebuild once its
  window clears (warm caches: zero compiles on re-admission).  SUSPECT
  is never saturation evidence: a gray replica can slow the fleet, it
  must not talk it into a coordinated brownout.
- **Failover**: a request failed by a crashed or stopped replica is
  resubmitted to a healthy one — within the request's ORIGINAL
  deadline (the clock is never reset) and a bounded per-request
  failover budget (never refreshed by a resubmission), so a poisoned
  request cannot ping-pong around the fleet forever.  With
  ``hedge_after`` set, a request stuck past that long on its primary
  is duplicated onto a second replica and the first completion wins
  (greedy decode is deterministic, so duplicates agree).
- **Rolling drain/restart**: ``drain(name)`` quiesces one replica
  through the engine's SIGTERM drain path while traffic steers away;
  ``restart(name)`` rebuilds it; ``rolling_restart()`` chains both
  across the fleet for zero-downtime upgrades.  ``stop()`` drains ALL
  replicas concurrently under one deadline, and a replica that hangs
  in drain is condemned (watchdog-killed) rather than wedging fleet
  shutdown.

Fault-injection sites (docs/resilience.md): ``fleet.route`` (before
affinity-key computation — faults degrade to least-loaded placement),
``fleet.failover`` (before a resubmission — faults abort that failover
attempt), ``fleet.drain`` (per-replica shutdown worker — a delay here
models a replica hanging in drain, which the stop deadline must
condemn).

Observability: every replica engine already exports per-engine labeled
series (unique ``engine=`` names); the router adds a ``fleet:<name>``
collector with routing/failover/lifecycle counters, per-replica
up/routed series, and the fleet-aggregated prefix hit rate, all under
``mxtpu_fleet_*`` names in the same process-wide ``collect()``.
"""
from __future__ import annotations

import collections
import random as _pyrandom
import signal as _signal
import statistics as _statistics
import threading
import time
import weakref
from typing import Callable, List, Optional, Sequence, Set, Tuple

import numpy as onp

from ..analysis.lockwitness import (named_lock as _named_lock,
                                    note_blocking as _note_blocking)
from ..observability.flightrecorder import active as _fr_active
from ..resilience.faults import inject as _inject
from ..serving.errors import (DeadlineInfeasibleError, EngineCrashedError,
                              EngineStoppedError, FleetSaturatedError,
                              InvalidRequestError, NoHealthyReplicaError,
                              QueueFullError, RequestCancelledError,
                              RequestTimeoutError, ServingError)
from ..serving.overload import CircuitBreaker, RetryBudget
from .directory import FleetDirectory
from .policy import RoutingPolicy
from .replica import (DEAD, DRAINING, HEALTHY, STOPPED, SUSPECT,
                      ReplicaHandle)

__all__ = ["FleetRouter", "FleetFuture"]


class _FleetRequest:
    """Replica-independent request record — everything needed to
    resubmit the request to another replica on failover."""

    __slots__ = ("payload", "kind", "max_new_tokens", "eos_id", "deadline",
                 "failovers_left", "priority", "sampling")

    def __init__(self, payload, kind, max_new_tokens, eos_id, deadline,
                 failovers, priority=None, sampling=None):
        self.payload = payload
        self.kind = kind
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.deadline = deadline          # absolute monotonic, never reset
        self.failovers_left = failovers   # never refreshed
        self.priority = priority          # QoS class, carried on failover
        # per-request sampling params (docs/serving.md), carried on
        # every failover/hedge attempt: draws fold the request seed
        # with ABSOLUTE token positions, so a resubmitted request
        # reproduces the same stream on any replica
        self.sampling = sampling or {}

    def remaining(self, now: Optional[float] = None) -> Optional[float]:
        if self.deadline is None:
            return None
        now = time.monotonic() if now is None else now
        return self.deadline - now


class FleetFuture:
    """The router-side future: resolves like an engine future, but a
    replica-level failure (``EngineCrashedError`` / ``EngineStoppedError``)
    — or a queued attempt priority-EVICTED by that replica
    (``QueueFullError`` on the inner future, docs/overload.md) —
    triggers failover instead of surfacing — the caller only ever sees
    a result, a request-level typed error, or a fleet-level typed error
    once budget/deadline/replicas are exhausted.  ``trace_id`` follows
    the CURRENT attempt (each engine submit allocates its own)."""

    def __init__(self, router: "FleetRouter", req: _FleetRequest,
                 handle: ReplicaHandle, inner):
        self._router = router
        self._req = req
        self._lock = _named_lock("fleet.future",
                                 "per-request attempt list")
        self._attempts: List[Tuple[ReplicaHandle, object]] = [(handle, inner)]
        self._exc: Optional[BaseException] = None   # terminal failure
        self._hedged = False
        self._t_submit = time.monotonic()
        # per-ATTEMPT submit stamps: the completion latency fed to the
        # gray-failure tracker (docs/integrity.md) must charge each
        # replica only for ITS attempt, not the whole failover chain
        self._attempt_t = {inner: self._t_submit}
        self._observed = False
        self.trace_id = inner.trace_id

    def _observe(self, handle: ReplicaHandle, fut) -> None:
        """Feed the winning attempt's server-side latency (submit →
        ``t_done``) to its replica's tracker, exactly once per request —
        repeat ``result()`` calls and concurrent waiters must not
        multiply one completion into several samples."""
        with self._lock:
            if self._observed:
                return
            self._observed = True
            t0 = self._attempt_t.get(fut)
        if t0 is None:
            return
        t1 = fut.t_done if getattr(fut, "t_done", None) is not None \
            else time.monotonic()
        self._router._observe_completion(handle, max(0.0, t1 - t0))

    def done(self) -> bool:
        """True once ANY attempt has resolved (a hint for pollers; a
        done-with-replica-failure attempt still fails over inside
        ``result()``) or the request failed terminally."""
        with self._lock:
            return self._exc is not None or \
                any(f.done() for _h, f in self._attempts)

    def result(self, timeout: Optional[float] = None):
        _note_blocking("fleet.future_wait")
        client_deadline = None if timeout is None else \
            time.monotonic() + timeout
        while True:
            with self._lock:
                if self._exc is not None:
                    # terminal (failover exhausted / deadline blown):
                    # repeat calls — or a second waiting thread — see
                    # the same typed error, like an engine future
                    raise self._exc
                attempts = list(self._attempts)
            primary_h, primary_f = attempts[0]
            # resolve any DONE attempt first (a hedge may beat the
            # primary); otherwise block a short chunk on the primary so
            # the common single-attempt path costs no busy-wait
            ready = [(h, f) for h, f in attempts if f.done()]
            if not ready:
                chunk = 0.05
                if client_deadline is not None:
                    chunk = min(chunk, max(0.0, client_deadline
                                           - time.monotonic()))
                try:
                    val = primary_f.result(chunk)
                except TimeoutError:
                    val, ready = None, []
                except RequestCancelledError:
                    # this attempt lost a hedge race and was reaped —
                    # re-snapshot; the winner resolves next iteration
                    continue
                except DeadlineInfeasibleError:
                    raise      # admission-time reject: not latency evidence
                except RequestTimeoutError:
                    # a request the replica held past its deadline IS
                    # latency evidence — without this, a replica slow
                    # enough that everything times out would feed the
                    # gray detector nothing and keep its keyspace
                    self._observe(primary_h, primary_f)
                    raise
                except (EngineCrashedError, EngineStoppedError,
                        QueueFullError) as e:
                    # QueueFullError on a QUEUED future = the attempt
                    # was priority-EVICTED by a higher-class arrival on
                    # that replica (docs/overload.md) — a replica-local
                    # capacity decision, not the request's fault:
                    # re-place it elsewhere within the same failover /
                    # retry-budget / deadline bounds
                    self._drop_attempt(primary_h, primary_f, e)
                    continue
                else:
                    self.trace_id = primary_f.trace_id
                    self._observe(primary_h, primary_f)
                    self._reap_losers(primary_f)
                    return val
            for h, f in ready:
                try:
                    val = f.result(0)
                except TimeoutError:      # raced: no longer done — retry
                    continue
                except RequestCancelledError:
                    continue   # reaped hedge loser — the winner is
                               # also in (or about to enter) ready
                except DeadlineInfeasibleError:
                    raise      # admission-time reject: not latency evidence
                except RequestTimeoutError:
                    self._observe(h, f)   # held past deadline = evidence
                    raise
                except (EngineCrashedError, EngineStoppedError,
                        QueueFullError) as e:
                    self._drop_attempt(h, f, e)
                    break
                else:
                    self.trace_id = f.trace_id
                    self._observe(h, f)
                    self._reap_losers(f)
                    return val
            if ready:
                continue
            now = time.monotonic()
            if client_deadline is not None and now >= client_deadline:
                raise TimeoutError(
                    "result() wait timed out (the request may still "
                    "complete fleet-side)")
            self._maybe_hedge(now)

    def _reap_losers(self, winner) -> None:
        """Hedged-request cleanup (docs/overload.md): the first copy
        to complete wins; every OTHER in-flight attempt is actively
        cancelled — dequeued if still queued, its KV slot flagged
        reclaimable if mid-decode — instead of running to completion
        as pure waste.  Each attempt that was still live counts one
        ``hedges_wasted``.  Losers leave ``_attempts`` BEFORE their
        futures can resolve with ``RequestCancelledError``, so a repeat
        ``result()`` call (or a concurrent waiter) only ever sees the
        winner."""
        with self._lock:
            losers = [(h, f) for h, f in self._attempts if f is not winner]
            self._attempts[:] = [(h, f) for h, f in self._attempts
                                 if f is winner]
        for h, f in losers:
            try:
                if h.engine.cancel(f):
                    self._router._count("hedges_wasted")
            except Exception:
                pass               # cleanup is best-effort, never fatal

    def _drop_attempt(self, handle, fut, exc):
        """One attempt died with a REPLICA-level error (crash, stop,
        or queue eviction): if other (hedged) attempts are still in
        flight, just forget this one; otherwise fail over — the router
        resubmits within the request's budget and deadline, or
        re-raises."""
        if isinstance(exc, EngineCrashedError):
            # blame the engine that actually crashed: a disaggregated
            # request routed to a PREFILL replica can die on the DECODE
            # replica that adopted it — marking the routed handle dead
            # would execute the wrong replica (and, with one prefill
            # replica, take the whole admission path down with it)
            src = getattr(exc, "engine", None)
            victim = handle if src is None or src == handle.name \
                else self._router._by_name.get(src)
            if victim is not None and victim.mark_dead(str(exc)):
                self._router._replica_death(victim, str(exc))
        elif isinstance(exc, QueueFullError):
            # the replica shed queued work under pressure — same
            # breaker signal as a shed at submit
            handle.breaker.record_failure()
        with self._lock:
            try:
                self._attempts.remove((handle, fut))
            except ValueError:
                pass
            alive = bool(self._attempts)
        if alive:
            return
        if isinstance(exc, QueueFullError):
            # counted only when the eviction actually triggers a
            # failover attempt — a hedged sibling still in flight means
            # the drop is just forgotten, and the counter must
            # reconcile against `failovers` during incidents
            self._router._count("eviction_failovers")
        try:
            nxt = self._router._failover(self._req, exc)
        except BaseException as e:
            with self._lock:
                self._exc = e       # terminal: _attempts is empty now
            raise
        with self._lock:
            self._attempts.append(nxt)
            self._attempt_t[nxt[1]] = time.monotonic()

    def _maybe_hedge(self, now: float):
        r = self._router
        if r.hedge_after is None or self._hedged:
            return
        if now - self._t_submit < r.hedge_after:
            return
        self._hedged = True
        # a hedge is fleet-added retry load: it must fit the retry
        # budget or be skipped — hedging during an overload is exactly
        # the thundering-herd amplifier the budget exists to cap
        if not r._retry_budget.try_acquire(now=now):
            r._count("retry_budget_exhausted")
            return
        with self._lock:
            exclude = {h.name for h, _f in self._attempts}
        try:
            nxt = r._submit_once(self._req, exclude=exclude)
        except ServingError:
            # hedging is an optimization, never fatal — and a hedge
            # that placed NOTHING added no retry load, so its token
            # goes back (shed probes are O(admission check), not work)
            r._retry_budget.refund()
            return
        r._count("hedges")
        with self._lock:
            self._attempts.append(nxt)
            self._attempt_t[nxt[1]] = time.monotonic()


class FleetRouter:
    """Front N engine replicas behind the single-engine surface.

    Parameters
    ----------
    engines : existing engines to wrap, one replica each (their claimed
        ``name`` becomes the replica name).  Dead replicas can only be
        re-admitted when a ``factory`` is also given.
    factory : ``factory(replica_name) -> InferenceEngine`` — builds a
        replica.  With ``num_replicas`` (and no ``engines``) the router
        builds the initial fleet ``<name>-r0 … <name>-r{N-1}`` itself;
        it is also how a dead replica is rebuilt after probation and
        how ``restart()`` works.  Pass ``name=replica_name`` through to
        the engine so metrics labels follow the replica.
    num_replicas : fleet size when building from ``factory``.
    routing : ``'affinity'`` (default — prefix-affinity with
        least-loaded spill), ``'least_loaded'``, or ``'random'``
        (seeded; the control arm for the fleet benchmark).
    affinity_min_tokens / affinity_window / tracker_entries : the
        :class:`~.policy.RoutingPolicy` knobs.
    spill_queue_depth : affinity target counts as SATURATED when its
        admission queue is at least this deep (default: 2x the first
        engine's ``num_slots``) — the spill trades a prefix hit for not
        queueing behind a hot replica.
    max_failovers : per-request budget of crash-failover resubmissions
        (the fleet-level analogue of the engine's per-request step-retry
        budget; never refreshed by a failover).
    hedge_after : seconds after which a still-unresolved request is
        duplicated onto a second healthy replica (None = no hedging).
        The winning copy actively CANCELS the loser (dequeue, or slot
        reclaim mid-decode) — counted as ``hedges_wasted``.
    retry_budget_rate / retry_budget_burst : token bucket bounding
        fleet-ADDED retry load (docs/overload.md): every failover
        resubmission and every hedge spends a token; an empty bucket
        surfaces the original failure typed (failover) or skips the
        hedge, so a replica crash during saturation cannot amplify
        into a thundering herd.
    breaker_threshold / breaker_cooldown : per-replica circuit breaker
        — that many consecutive sheds / replica-level submit failures
        stop the router offering the replica traffic for the cooldown,
        then half-open with a probe.
    saturation_threshold / saturation_window / saturation_brownout :
        coordinated brownout — that many all-replicas-shed submits
        within the window force every replica's overload controller to
        its brownout floor (``engine.force_brownout()``), and the
        caller sees the typed :class:`FleetSaturatedError` (a
        ``QueueFullError`` subclass) instead of an opaque shed.
    health_interval : monitor poll period in seconds.
    gray_multiplier / gray_min_samples / gray_window : gray-failure
        ejection (docs/integrity.md): a HEALTHY replica whose
        completion-latency EWMA *and* windowed p99 are at least
        ``gray_multiplier`` times its peer median (median of the OTHER
        eligible replicas' EWMAs — self-excluded so an outlier cannot
        inflate its own bar; at least two replicas with
        ``gray_min_samples`` completions in their
        ``gray_window``-sample windows) goes
        ``SUSPECT`` — unroutable but alive, re-admitted without rebuild
        after the probation ladder's window.  ``gray_ejection=False``
        disables the detector (the trackers still feed, for the
        per-replica latency gauges).
    probation / probation_backoff / probation_max : re-admission window
        after a replica death: ``probation * backoff**(deaths-1)``
        seconds, capped.  Gray suspensions ride the same ladder, keyed
        on consecutive suspect ejections.
    restart_warmup : re-run ``warmup()`` on rebuilt/restarted replicas
        so re-admission never compiles on live traffic.
    drain_timeout : default deadline for ``stop()`` / the SIGTERM drain
        (None = wait indefinitely; a hung replica still cannot wedge
        shutdown forever — its engine watchdog or an explicit timeout
        condemns it).
    name : fleet name — the ``fleet=`` label on every ``mxtpu_fleet_*``
        series and the default prefix for factory-built replica names.
    """

    def __init__(self, engines: Optional[Sequence] = None, *,
                 factory: Optional[Callable] = None,
                 num_replicas: Optional[int] = None,
                 routing: str = "affinity",
                 affinity_min_tokens: int = 4,
                 affinity_window: int = 32,
                 tracker_entries: int = 512,
                 spill_queue_depth: Optional[int] = None,
                 max_failovers: int = 2,
                 hedge_after: Optional[float] = None,
                 retry_budget_rate: float = 2.0,
                 retry_budget_burst: int = 8,
                 breaker_threshold: int = 5,
                 breaker_cooldown: float = 0.5,
                 saturation_threshold: int = 3,
                 saturation_window: float = 1.0,
                 saturation_brownout: bool = True,
                 gray_ejection: bool = True,
                 gray_multiplier: float = 4.0,
                 gray_min_samples: int = 12,
                 gray_window: int = 64,
                 health_interval: float = 0.05,
                 probation: float = 0.25,
                 probation_backoff: float = 2.0,
                 probation_max: float = 30.0,
                 restart_warmup: bool = True,
                 drain_timeout: Optional[float] = None,
                 seed: int = 0,
                 name: str = "fleet"):
        if routing not in ("affinity", "least_loaded", "random"):
            raise ServingError(f"routing must be 'affinity'|'least_loaded'|"
                             f"'random', got {routing!r}")
        self.name = str(name)
        self.routing = routing
        self.factory = factory
        self.max_failovers = int(max_failovers)
        self.hedge_after = hedge_after
        self.health_interval = float(health_interval)
        self.drain_timeout = drain_timeout
        # retry-storm protection (docs/overload.md)
        self._retry_budget = RetryBudget(retry_budget_rate,
                                         retry_budget_burst)
        self._breaker_threshold = int(breaker_threshold)
        self._breaker_cooldown = float(breaker_cooldown)
        self.saturation_threshold = int(saturation_threshold)
        self.saturation_window = float(saturation_window)
        self.saturation_brownout = bool(saturation_brownout)
        # gray-failure defense (docs/integrity.md)
        self.gray_ejection = bool(gray_ejection)
        self.gray_multiplier = float(gray_multiplier)
        self.gray_min_samples = int(gray_min_samples)
        self.gray_window = int(gray_window)
        self._sat_lock = _named_lock("fleet.router.saturation",
                                     "all-replicas-shed event window")
        # last `saturation_threshold` all-replicas-shed event times
        self._sat_times = collections.deque(
            maxlen=max(1, self.saturation_threshold))
        self._sat_brownout_at = -1e9
        self._policy = RoutingPolicy(affinity_min_tokens, affinity_window,
                                     tracker_entries)
        self._rng = _pyrandom.Random(int(seed))
        self._rng_lock = _named_lock("fleet.router.rng",
                                     "seeded routing tiebreak RNG")

        if engines is None:
            if factory is None or not num_replicas:
                raise ServingError(
                    "FleetRouter needs engines=[...] or factory= + "
                    "num_replicas=N")
            engines = [factory(f"{self.name}-r{i}")
                       for i in range(int(num_replicas))]
            names = [f"{self.name}-r{i}" for i in range(int(num_replicas))]
        else:
            engines = list(engines)
            if not engines:
                raise ServingError("FleetRouter needs at least one replica")
            names = [e.name for e in engines]
        if len(set(names)) != len(names):
            raise ServingError(f"replica names must be unique, got {names}")
        mode = engines[0].mode
        if any(e.mode != mode for e in engines):
            raise ServingError("all replicas must share one mode "
                               "(decode or forward)")
        self.mode = mode
        # kept for elastic scale-up: a newcomer's handle must ride the
        # same probation/backoff/warmup contract as the founders
        self._handle_kw = dict(probation=probation,
                               probation_backoff=probation_backoff,
                               probation_max=probation_max,
                               restart_warmup=restart_warmup,
                               latency_window=self.gray_window)
        self._handles = [
            ReplicaHandle(n, e, factory=factory,
                          breaker=CircuitBreaker(self._breaker_threshold,
                                                 self._breaker_cooldown),
                          **self._handle_kw)
            for n, e in zip(names, engines)]
        self._by_name = {h.name: h for h in self._handles}
        # serializes scale_up/scale_down against each other and against
        # drain/stop; routing threads read _handles/_by_name without it
        # (mutation is copy-then-atomic-reassign, never in place)
        self._scale_lock = _named_lock("fleet.router.scale",
                                       "elastic membership changes")
        self._scale_seq = len(self._handles)
        self.spill_queue_depth = int(spill_queue_depth) \
            if spill_queue_depth is not None \
            else max(2, 2 * engines[0].num_slots)
        # fleet-wide prefix/page directory (docs/fleet.md
        # "Disaggregated serving"): affinity key -> the replica whose
        # pool actually HOLDS that family's KV.  Consulted ahead of the
        # stateless HRW rank for both unified placement and migrated
        # decode placement; published wherever residency is created.
        self._directory = FleetDirectory(tracker_entries)
        # disaggregated prefill/decode fleet: any replica carrying a
        # non-unified role splits placement two-stage — new requests go
        # to prefill-capable replicas by load, and each prefill-role
        # engine's migration egress is wired into the router's decode
        # placement (directory affinity, then HRW, then load)
        self.disaggregated = any(h.role != "unified"
                                 for h in self._handles)
        if self.disaggregated:
            if self.mode != "decode":
                raise ServingError(
                    "disaggregated roles are a decode-mode concept; "
                    "this fleet serves forward mode")
            if not any(h.can_prefill() for h in self._handles):
                raise ServingError(
                    "disaggregated fleet has no prefill-capable "
                    "replica (role='prefill' or 'unified') — nothing "
                    "could ever accept a request")
            if not any(h.can_decode() for h in self._handles):
                raise ServingError(
                    "disaggregated fleet has no decode-capable replica "
                    "(role='decode' or 'unified') — every handoff "
                    "would fall back colocated")
            for h in self._handles:
                self._wire_migration(h)

        self._counters = {}
        self._counters_lock = _named_lock("fleet.router.counters",
                                          "fleet counter map")
        self._mon_stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._stop_lock = _named_lock("fleet.router.stop",
                                      "stop()/drain mutual exclusion")
        self._stopping = False
        self._prev_handlers = None
        self._register_collector()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FleetRouter":
        if self._monitor is not None:
            raise ServingError("router already started")
        if self._stopping:  # raceguard: unguarded(one-way stop flag: atomic bool read; the stop path itself serializes under _stop_lock)
            raise ServingError("router cannot be restarted once stopped "
                               "— build a fresh FleetRouter")
        for h in self._members:
            if h.engine._thread is None:
                h.engine.start()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         name="mxnet_tpu_torch-fleet-monitor",
                                         daemon=True)
        self._monitor.start()
        return self

    def warmup(self, **kw) -> dict:
        """Pre-compile every replica's lattice; returns
        ``{replica_name: programs_compiled}``.  After this, each
        replica's ``compiles`` counter must stay frozen on traffic —
        the same contract as the single engine."""
        return {h.name: h.engine.warmup(**kw) for h in self._members}

    def __enter__(self):
        if self._monitor is None:
            self.start()
        return self

    def __exit__(self, *exc):
        self.stop(drain=not any(exc))

    def stop(self, drain: bool = True, timeout: Optional[float] = None):
        """Stop the fleet: every replica drains CONCURRENTLY (a fleet
        of N must not pay N serial drains) under one deadline
        (``timeout``, default ``drain_timeout``).  A replica whose
        drain outlives the deadline — hung scheduler, injected
        ``fleet.drain`` delay — is CONDEMNED (its queued/in-flight
        requests fail typed, exactly the watchdog contract) rather than
        wedging shutdown.  Nothing is silently dropped: each engine's
        own stop/sweep guarantees carry over per replica."""
        with self._stop_lock:
            self._stopping = True
            self._mon_stop.set()
            mon = self._monitor
            if mon is not None and mon.is_alive() and \
                    mon is not threading.current_thread():
                mon.join(2.0)
            timeout = self.drain_timeout if timeout is None else timeout
            deadline = None if timeout is None else \
                time.monotonic() + float(timeout)
            workers = []
            for h in self._members:
                with h._lock:
                    if h.state in (HEALTHY, DRAINING, SUSPECT):
                        # SUSPECT replicas drain too: slow, not dead —
                        # their in-flight work still deserves the drain
                        h.state = DRAINING
                    elif h.state == STOPPED:
                        continue
                t = threading.Thread(
                    target=self._shutdown_replica, args=(h, drain, deadline),
                    name=f"mxnet_tpu_torch-fleet-drain-{h.name}", daemon=True)
                t.start()
                workers.append((h, t))
            for h, t in workers:
                budget = None if deadline is None else \
                    max(0.0, deadline - time.monotonic())
                t.join(budget)
            for h, t in workers:
                if t.is_alive():
                    # the drain worker itself is stuck (e.g. a delay at
                    # fleet.drain): condemn from here — the worker's own
                    # engine.stop() then returns promptly on the crashed
                    # path and the futures are already failed typed
                    self._count("forced_stops")
                    try:
                        h.engine.condemn(
                            "fleet stop deadline exceeded — replica drain "
                            "did not complete in time")
                    except Exception:
                        pass
                    with h._lock:
                        h.state = STOPPED
            self.uninstall_signal_handlers()

    def _shutdown_replica(self, h: ReplicaHandle, drain: bool,
                          deadline: Optional[float]):
        try:
            _inject("fleet.drain")
        except BaseException:
            # an injected drain fault: the graceful path is broken, go
            # straight to the force-stop path rather than aborting the
            # shutdown of this replica
            self._count("drain_faults")
            drain = False
        budget = None if deadline is None else \
            max(0.1, deadline - time.monotonic())
        try:
            h.engine.stop(drain=drain, timeout=budget)
        except ServingError:
            # still draining at its deadline: watchdog-kill the replica
            # instead of wedging the fleet — condemnation fails every
            # queued/in-flight request typed, then the engine's stop
            # path returns promptly
            self._count("forced_stops")
            try:
                h.engine.condemn("fleet drain deadline exceeded — "
                                 "force-stopping replica")
                h.engine.stop(drain=False, timeout=2.0)
            except Exception:
                pass
        except Exception:
            pass
        with h._lock:
            h.state = STOPPED

    # ------------------------------------------------------ rolling drain
    def drain(self, replica: str, timeout: Optional[float] = None):
        """Quiesce ONE replica: new traffic steers away immediately,
        queued and in-flight requests on it complete (the SIGTERM drain
        path), then the engine stops.  The replica ends ``STOPPED`` —
        ``restart()`` brings it back.  A drain that outlives ``timeout``
        condemns the replica (see ``stop()``)."""
        if self._stopping:  # raceguard: unguarded(one-way stop flag: atomic bool read; the stop path itself serializes under _stop_lock)
            raise ServingError("fleet router is stopped")
        h = self._require(replica)
        with h._lock:
            if h.state not in (HEALTHY, SUSPECT):
                raise ServingError(f"replica {replica!r} is {h.state}, "
                                   "not drainable")
            h.state = DRAINING
            # flag the drain as DELIBERATE: the autoscaler must not
            # read this replica as shrink headroom, nor its rising
            # queue as saturation evidence (docs/fleet.md "Elastic
            # fleet" — the drain-vs-autoscaler race)
            h.manual_drain = True
        self._count("drains")
        deadline = None if timeout is None else time.monotonic() + timeout
        self._shutdown_replica(h, True, deadline)

    def restart(self, replica: str) -> bool:
        """Rebuild a drained/dead replica via the factory (fresh engine
        under the same replica name, re-warmed) and return it to
        traffic."""
        if self._stopping:  # raceguard: unguarded(one-way stop flag: atomic bool read; the stop path itself serializes under _stop_lock)
            raise ServingError("fleet router is stopped")
        h = self._require(replica)
        if h.factory is None:
            raise ServingError("restart() needs an engine factory — "
                               "construct the FleetRouter with factory=")
        if h.state == HEALTHY:
            raise ServingError(f"replica {replica!r} is healthy — drain "
                               "it first")
        if not h.rebuild():
            raise ServingError(f"replica {replica!r} rebuild failed: "
                               f"{h.last_error}")
        h.manual_drain = False
        self._wire_migration(h)
        self._count("restarts")
        return True

    def rolling_restart(self, timeout: Optional[float] = None):
        """Zero-downtime fleet restart: drain + rebuild each replica in
        sequence while the rest keep serving."""
        for h in list(self._members):
            self.drain(h.name, timeout=timeout)
            self.restart(h.name)

    def replace(self, replica: str, engine) -> None:
        """Swap a fresh, caller-built engine into a non-healthy replica
        slot (the no-factory escape hatch)."""
        h = self._require(replica)
        if h.state == HEALTHY:
            raise ServingError(f"replica {replica!r} is healthy — drain "
                               "it first")
        if engine._thread is None:
            engine.start()
        with h._lock:
            h.engine = engine
            h.state = HEALTHY
            h.restarts += 1
            h.probation_until = None
            h.suspect_until = None
            h.manual_drain = False
        h.latency.reset()

    # Membership is copy-on-write: scale_up/scale_down build a NEW
    # list/dict under _scale_lock and reassign the reference, so a
    # lock-free reader sees either the old or the new membership —
    # never a half-built one — and a stale snapshot is benign (routing
    # re-checks replica state; stats lag at most one scaling action).
    # Every lock-free read goes through these two accessors so the
    # contract lives in exactly one place.
    @property
    def _members(self) -> List[ReplicaHandle]:
        return self._handles  # raceguard: unguarded(copy-on-write membership: writers reassign a fresh list under _scale_lock; a reference read is atomic and a stale snapshot benign)

    @property
    def _name_map(self) -> dict:
        return self._by_name  # raceguard: unguarded(copy-on-write membership: writers reassign a fresh dict under _scale_lock; a reference read is atomic and a stale snapshot benign)

    def _require(self, replica: str) -> ReplicaHandle:
        h = self._name_map.get(replica)
        if h is None:
            raise ServingError(f"unknown replica {replica!r} — have "
                               f"{sorted(self._name_map)}")
        return h

    # ------------------------------------------------------ elastic scaling
    def draining(self) -> List[str]:
        """Replicas currently in a DELIBERATE drain (manual ``drain()``
        / ``rolling_restart()`` in flight) — the autoscaler holds its
        decisions while one exists: the shrinking fleet and the
        victim's rising queue are expected, not evidence."""
        return [h.name for h in self._members
                if h.manual_drain and h.state in (DRAINING, STOPPED)]

    def _next_replica_name(self) -> str:  # guarded-by: _scale_lock
        while True:
            name = f"{self.name}-r{self._scale_seq}"
            self._scale_seq += 1
            if name not in self._by_name:
                return name

    def scale_up(self, name: Optional[str] = None,
                 signals: Optional[dict] = None) -> Optional[str]:
        """Grow the fleet by one factory-built replica (docs/fleet.md
        "Elastic fleet").  The newcomer is started and **warmed before
        it joins the routing tables**, so it never compiles on live
        traffic — the same re-warm contract as probation rebuilds.  HRW
        placement then remaps only ~1/N of the keyspace, all of it onto
        the newcomer.

        A fault injected at ``fleet.scale_up`` degrades the action to a
        counted no-op BEFORE any engine is built — the fleet is left
        exactly as it was.  Returns the new replica's name, or ``None``
        on a faulted/no-op action."""
        if self._stopping:  # raceguard: unguarded(one-way stop flag: atomic bool read; the stop path itself serializes under _stop_lock)
            raise ServingError("fleet router is stopped")
        if self.factory is None:
            raise ServingError("scale_up() needs an engine factory — "
                               "construct the FleetRouter with factory=")
        with self._scale_lock:
            try:
                _inject("fleet.scale_up")
            except BaseException:
                self._count("scale_up_faults")
                return None
            new_name = name if name is not None \
                else self._next_replica_name()
            if new_name in self._by_name:
                raise ServingError(
                    f"replica name {new_name!r} already in the fleet")
            try:
                eng = self.factory(new_name)
                if eng.mode != self.mode:
                    raise ServingError(
                        f"factory built a {eng.mode}-mode engine for a "
                        f"{self.mode}-mode fleet")
                if eng._thread is None:
                    eng.start()
                # warm BEFORE taking traffic: the compile freeze must
                # hold from the newcomer's first routed request
                eng.warmup()
            except ServingError:
                raise
            except Exception as e:
                try:
                    eng.stop(drain=False, timeout=1.0)
                except Exception:
                    pass
                self._count("scale_up_failures")
                raise ServingError(
                    f"scale_up: building replica {new_name!r} failed: "
                    f"{e!r}") from e
            if self._stopping:  # raceguard: unguarded(one-way stop flag: atomic bool read; the stop path itself serializes under _stop_lock)
                # the fleet stopped while the newcomer warmed: joining
                # now would strand a live engine no shutdown walks —
                # discard it and degrade to a counted no-op
                try:
                    eng.stop(drain=False, timeout=1.0)
                except Exception:
                    pass
                self._count("scale_up_aborts")
                return None
            h = ReplicaHandle(
                new_name, eng, factory=self.factory,
                breaker=CircuitBreaker(self._breaker_threshold,
                                       self._breaker_cooldown),
                **self._handle_kw)
            self._wire_migration(h)
            # copy-then-reassign: routing threads iterate _handles /
            # read _by_name without the scale lock, so membership must
            # flip atomically, never mutate in place
            self._by_name = {**self._by_name, new_name: h}
            self._handles = self._handles + [h]
            self._count("scale_ups")
            fr = _fr_active()
            if fr is not None:
                fr.record("fleet.scale_up", fleet=self.name,
                          replica=new_name,
                          replicas=len(self._handles),
                          **(signals or {}))
            return new_name

    def scale_down(self, replica: Optional[str] = None,
                   timeout: Optional[float] = None, reseed: bool = True,
                   signals: Optional[dict] = None) -> Optional[str]:
        """Shrink the fleet by one replica, loss-free (docs/fleet.md
        "Elastic fleet"): the victim (named, or the least-loaded
        healthy replica) stops taking new traffic immediately, its
        queued and in-flight requests DRAIN to completion, its hot
        prefix entries are exported and re-seeded onto the survivors
        (HRW-targeted per family, via the ordinary prefix-insert path —
        under paged KV a refcount-claim handoff), the fleet directory
        forgets it, and only then does it leave the membership.  Warm
        prompt families stay warm; zero requests are lost.

        A fault injected at ``fleet.scale_down`` degrades the action to
        a counted no-op BEFORE the victim starts draining — a faulted
        scale action never strands a replica half-drained.  Returns the
        removed replica's name, or ``None`` on a faulted/no-op
        action."""
        if self._stopping:  # raceguard: unguarded(one-way stop flag: atomic bool read; the stop path itself serializes under _stop_lock)
            raise ServingError("fleet router is stopped")
        with self._scale_lock:
            healthy = self._healthy()
            if replica is None:
                candidates = [h for h in healthy]
                if not candidates:
                    raise NoHealthyReplicaError(
                        f"fleet {self.name!r}: no healthy replica to "
                        f"scale down")
                h = min(candidates, key=lambda c: (c.load(), c.name))
            else:
                h = self._require(replica)
            survivors = [s for s in healthy if s is not h]
            if not survivors:
                raise ServingError(
                    f"scale_down would leave fleet {self.name!r} with "
                    f"no healthy replica — refusing")
            try:
                _inject("fleet.scale_down")
            except BaseException:
                # degrade to no-op: the victim has not been touched —
                # it keeps serving, nothing is half-drained
                self._count("scale_down_faults")
                return None
            with h._lock:
                if h.state not in (HEALTHY, SUSPECT):
                    raise ServingError(
                        f"replica {h.name!r} is {h.state}, not "
                        f"removable — scale_down wants a live victim")
                h.state = DRAINING
            # 1) loss-free drain: queued + in-flight requests complete
            #    (the SIGTERM drain path; a hang is condemned, typed)
            deadline = None if timeout is None \
                else time.monotonic() + timeout
            self._shutdown_replica(h, True, deadline)
            # 2) harvest the victim's warm families off the stopped
            #    engine (its caches are still resident; best-effort)
            seeds = []
            if reseed:
                try:
                    seeds = h.engine.export_prefix_seeds()
                except Exception:
                    seeds = []
            # 3) membership flip (atomic reassign) + the directory
            #    forgets the corpse so no placement steers at it — a
            #    stale locate degrades to directory-second placement,
            #    but why pay the typed miss at all
            self._handles = [x for x in self._handles if x is not h]
            self._by_name = {n: x for n, x in self._by_name.items()
                             if x is not h}
            forgotten = self._directory.forget_replica(h.name)
            # 4) re-seed survivors: each family lands on its HRW winner
            #    among the remaining replicas — exactly where the
            #    router will place its next member
            planted = self._reseed(seeds)
            self._count("scale_downs")
            fr = _fr_active()
            if fr is not None:
                fr.record("fleet.scale_down", fleet=self.name,
                          replica=h.name,
                          replicas=len(self._handles),
                          seeds_exported=len(seeds),
                          seeds_planted=planted,
                          directory_forgotten=forgotten,
                          **(signals or {}))
            return h.name

    def _reseed(self, seeds) -> int:
        """Plant exported prefix seeds on the survivors: HRW-target
        each family's winner first (that is where followers will
        route), spilling down the rank on refusal.  Residency is
        published to the directory wherever a seed lands, so the next
        family member gets a directory hit, not a cold miss.  Returns
        the number of seeds planted."""
        planted = 0
        for seed in seeds:
            candidates = self._healthy()
            if not candidates:
                break
            key = None
            try:
                key = self._policy.peek_key(seed.tokens)
            except Exception:
                pass
            if key is not None:
                ranked = self._policy.rank(key,
                                           [c.name for c in candidates])
                order = [self._name_map[n] for n in ranked
                         if n in self._name_map]
            else:
                order = sorted(candidates,
                               key=lambda c: (c.load(), c.name))
            for target in order:
                try:
                    if target.engine.seed_prefix(seed):
                        planted += 1
                        self._directory.publish(key, target.name)
                        break
                except ServingError:
                    continue       # typed refusal: offer the next survivor
                except Exception:
                    continue
        if planted:
            self._count("seeds_migrated", planted)
        return planted

    # --------------------------------------------------------- SIGTERM
    def install_signal_handlers(self, signals=(_signal.SIGTERM,)):
        """Route SIGTERM (the preemption notice) to a concurrent
        fleet-wide ``stop(drain=True)`` on a helper thread, bounded by
        ``drain_timeout``."""
        prev = {}
        for s in signals:
            prev[s] = _signal.signal(s, self._on_term_signal)
        self._prev_handlers = prev
        return prev

    def uninstall_signal_handlers(self):
        if self._prev_handlers and \
                threading.current_thread() is threading.main_thread():
            for s, hd in self._prev_handlers.items():
                try:
                    _signal.signal(s, hd)
                except (ValueError, TypeError):
                    pass
            self._prev_handlers = None

    def _on_term_signal(self, signum, frame):
        def _drain():
            # bundle on the helper thread, never inside the handler:
            # the interrupted frame may hold locks the bundle's
            # registry collect() needs (engine.py has the same shape)
            fr = _fr_active()
            if fr is not None:
                fr.trigger("signal.sigterm", fleet=self.name,
                           signum=signum)
            self.stop(drain=True)

        threading.Thread(target=_drain,
                         name="mxnet_tpu_torch-fleet-drain",
                         daemon=True).start()

    # ------------------------------------------------------------ forensics
    def _replica_death(self, h: ReplicaHandle, reason: str) -> None:
        """One replica transitioned to DEAD (monitor probe, failing
        submit, or a dropped in-flight attempt): count it, and give the
        flight recorder its trigger — a replica death is exactly the
        moment an operator asks what the fleet was doing."""
        self._count("replica_deaths")
        # a corpse must not attract affinity traffic: drop every
        # directory entry pointing at it (a rebuilt successor starts
        # with an empty pool and re-earns residency on fresh traffic)
        self._directory.forget_replica(h.name)
        fr = _fr_active()
        if fr is not None:
            fr.trigger("fleet.replica_death", fleet=self.name,
                       replica=h.name, reason=reason,
                       deaths=h.total_deaths)

    # ------------------------------------------------- disaggregated serving
    def _wire_migration(self, h: ReplicaHandle) -> None:
        """(Re)attach a prefill-role replica's migration egress to the
        router's decode-placement shim.  Called at construction and
        after every rebuild — a fresh engine starts with no target, and
        an unwired prefill replica silently serves colocated, which is
        safe but defeats the disaggregation."""
        if h.role != "prefill":
            return
        h.engine.migrate_to(
            lambda bundle, future: self._place_decode(bundle, future))

    def _decode_order(self, key: Optional[bytes],
                      candidates: List[ReplicaHandle]
                      ) -> List[ReplicaHandle]:
        """Decode-stage placement order: directory affinity (the
        replica already holding this family's pages — a cross-replica
        prefix hit on arrival), then HRW rank, then load.  Saturated
        affinity targets spill to the back exactly like unified
        placement."""
        by_load = sorted(candidates, key=lambda h: (h.load(), h.name))
        if key is None:
            return by_load
        byname = {h.name: h for h in candidates}
        loc = self._directory.locate(key)
        target = byname.get(loc) if loc is not None else None
        if target is not None and \
                not target.saturated(self.spill_queue_depth):
            self._count("directory_hits")
            return [target] + [h for h in by_load if h is not target]
        self._count("directory_misses")
        ranked = self._policy.rank(key, list(byname))
        target = byname[ranked[0]]
        rest = [h for h in by_load if h is not target]
        if target.saturated(self.spill_queue_depth):
            return rest + [target]
        return [target] + rest

    def _place_decode(self, bundle, future) -> None:
        """Place one migrated KV bundle on a decode-capable replica
        (the second stage of disaggregated placement).  Walks the
        decode order, offering the bundle via ``adopt()``; the first
        acceptor owns the request and its residency is published to
        the directory so the family's followers decode on the same
        pool.  Raises typed when nobody accepts — the prefill engine
        catches it and finishes the request itself (colocated
        fallback), so a refusal here degrades, never loses."""
        candidates = [h for h in self._healthy() if h.can_decode()]
        if not candidates:
            self._count("migration_spills")
            raise NoHealthyReplicaError(
                f"fleet {self.name!r}: no healthy decode-capable "
                f"replica to adopt the bundle")
        # the affinity key rides the bundle as submit()'s route_hint —
        # re-deriving it here would self-match the prompt in the radix
        # tracker (it was recorded at the prefill routing stage) and
        # key every family member uniquely
        key = bundle.route_hint
        last: Optional[Exception] = None
        for h in self._decode_order(key, candidates):
            try:
                h.engine.adopt(bundle, future)
            except ServingError as e:
                # typed refusal (out of slots/pages, stopping, injected
                # migrate_in fault): offer the next candidate
                last = e
                continue
            h.routed += 1
            self._count("migrations")
            self._directory.publish(key, h.name)
            return
        self._count("migration_spills")
        raise last if last is not None else NoHealthyReplicaError(
            f"fleet {self.name!r}: every decode-capable replica "
            f"refused the bundle")

    # ----------------------------------------------------------- monitor
    def _monitor_loop(self):
        while not self._mon_stop.wait(self.health_interval):
            for h in self._members:
                try:
                    if h.probe():
                        self._replica_death(h, h.last_error
                                            or "health probe failed")
                    elif h.due_for_readmission() and not self._stopping:  # raceguard: unguarded(one-way stop flag: atomic bool read; the stop path itself serializes under _stop_lock)
                        # abort= closes the stop-vs-rebuild race: a
                        # rebuild still in flight when the fleet stops
                        # discards its replacement engine instead of
                        # resurrecting a replica on a stopped fleet
                        if h.rebuild(abort=lambda: self._stopping):  # raceguard: unguarded(one-way stop flag: atomic bool read; the stop path itself serializes under _stop_lock)
                            # a rebuilt prefill-role engine starts with
                            # no migration target — re-wire it
                            self._wire_migration(h)
                            self._count("readmissions")
                            fr = _fr_active()
                            if fr is not None:
                                fr.record("fleet.readmission",
                                          fleet=self.name,
                                          replica=h.name)
                    elif h.due_for_unsuspect() and not self._stopping:  # raceguard: unguarded(one-way stop flag: atomic bool read; the stop path itself serializes under _stop_lock)
                        # suspension elapsed: back to traffic with a
                        # fresh latency window — no rebuild, the engine
                        # never stopped (docs/integrity.md)
                        if h.unsuspect():
                            self._count("gray_readmissions")
                            fr = _fr_active()
                            if fr is not None:
                                fr.record("fleet.gray_readmission",
                                          fleet=self.name,
                                          replica=h.name)
                except Exception:
                    continue       # the monitor must outlive any probe
            try:
                self._gray_check()
            except Exception:
                pass               # ...and outlive the detector too

    def _gray_check(self, now: Optional[float] = None) -> None:
        """Gray-failure detector (docs/integrity.md): compare each
        HEALTHY replica's completion-latency EWMA + windowed p99 against
        the median of its PEERS' EWMAs — the candidate is excluded from
        its own median, else its own outlier latency inflates the very
        bar it is judged by (with two replicas the inclusive median
        makes ejection mathematically impossible for any multiplier
        >= 2).  An outlier ``gray_multiplier`` above its peer median
        (with ``gray_min_samples`` of evidence, and at least two
        replicas eligible so a peer exists to disagree with) is
        SUSPECT-ejected.  A replica comfortably under the bar resets
        its consecutive-suspect ladder, mirroring how a healthy probe
        resets the death ladder."""
        if not self.gray_ejection:
            return
        snaps = [(h, h.latency.snapshot()) for h in self._members
                 if h.state == HEALTHY]
        eligible = [(h, s) for h, s in snaps
                    if s["count"] >= self.gray_min_samples]
        if len(eligible) < 2:
            return
        ewmas = [s["ewma"] for _h, s in eligible]
        for i, (h, s) in enumerate(eligible):
            med = _statistics.median(ewmas[:i] + ewmas[i + 1:])
            if med <= 0.0:
                continue
            bar = self.gray_multiplier * med
            if s["ewma"] >= bar and s["p99"] >= bar:
                if h.mark_suspect(
                        f"gray failure: ewma {s['ewma'] * 1e3:.1f}ms / "
                        f"p99 {s['p99'] * 1e3:.1f}ms >= "
                        f"{self.gray_multiplier:g}x peer median "
                        f"{med * 1e3:.1f}ms over {s['count']} samples",
                        now):
                    self._count("gray_ejections")
                    fr = _fr_active()
                    if fr is not None:
                        fr.record("fleet.gray_ejection", fleet=self.name,
                                  replica=h.name,
                                  ewma_ms=round(s["ewma"] * 1e3, 2),
                                  p99_ms=round(s["p99"] * 1e3, 2),
                                  peer_median_ms=round(med * 1e3, 2))
            else:
                h.suspects = 0

    def _observe_completion(self, handle: ReplicaHandle,
                            seconds: float) -> None:
        """Completion path → gray-failure evidence: one served request's
        attempt latency lands in its replica's tracker."""
        handle.observe_latency(seconds)

    # ------------------------------------------------------------ routing
    def _healthy(self) -> List[ReplicaHandle]:
        return [h for h in self._members if h.routable()]

    def _order_candidates(self, payload
                          ) -> Tuple[List[ReplicaHandle],
                                     Optional[bytes]]:
        """Placement order for one NEW request, plus its affinity key
        (``None`` when unkeyed) so the caller can publish where it
        actually landed into the fleet directory.  In a disaggregated
        fleet this is the PREFILL stage: only prefill-capable replicas
        are candidates (decode-role replicas receive work through
        ``adopt()``), ordered by load — prefill is compute-bound, so
        load beats affinity here and the directory steers the DECODE
        stage instead."""
        healthy = self._healthy()
        if self.disaggregated:
            healthy = [h for h in healthy if h.can_prefill()]
        if not healthy:
            self._count("no_healthy")
            raise NoHealthyReplicaError(
                f"fleet {self.name!r}: no healthy "
                f"{'prefill-capable ' if self.disaggregated else ''}"
                f"replica ({ {h.name: h.state for h in self._members} })")
        key, faulted = None, False
        try:
            _inject("fleet.route")
            if self.routing == "affinity" and self.mode == "decode":
                key = self._policy.affinity_key(payload)
        except Exception:
            # contained: the request just loses the routing shortcut
            # and places least-loaded, it never fails
            self._count("route_faults")
            key, faulted = None, True
        if self.routing == "random" and not faulted:
            with self._rng_lock:
                order = list(healthy)
                self._rng.shuffle(order)
            self._count("random_routed")
            return order, None
        by_load = sorted(healthy, key=lambda h: (h.load(), h.name))
        if self.disaggregated:
            # prefill stage: pure load placement; the key still rides
            # back so the decode stage's directory learns the family
            self._count("least_loaded_routed")
            return by_load, key
        if key is None:
            self._count("least_loaded_routed")
            return by_load, None
        # directory affinity beats HRW: the replica that already HOLDS
        # this family's KV (learned from where earlier members landed)
        # wins even when the fleet membership changed since — HRW only
        # decides for families the directory has never seen
        loc = self._directory.locate(key)
        target = self._name_map.get(loc) if loc is not None else None
        if target is not None and target in healthy and \
                not target.saturated(self.spill_queue_depth):
            self._count("directory_hits")
            self._count("affinity_routed")
            return [target] + [h for h in by_load if h is not target], key
        # unknown family, or stale/unusable residency (dead replica,
        # saturated) — fall through to the stateless rank
        self._count("directory_misses")
        ranked = self._policy.rank(key, [h.name for h in healthy])
        target = self._name_map[ranked[0]]
        rest = [h for h in by_load if h is not target]
        if target.saturated(self.spill_queue_depth):
            self._count("affinity_spills")
            return rest + [target], key
        self._count("affinity_routed")
        return [target] + rest, key

    def _submit_once(self, req: _FleetRequest,
                     exclude: Optional[Set[str]] = None
                     ) -> Tuple[ReplicaHandle, object]:
        """Place ``req`` on the best available replica: walk the policy
        order, skipping replicas with an OPEN circuit breaker and
        replicas that shed, and marking replicas whose submit fails
        replica-level as dead.  When every candidate sheds (or sits
        behind an open breaker) the fleet is saturated: coordinated
        brownout is noted and the typed :class:`FleetSaturatedError`
        surfaces.  A :class:`DeadlineInfeasibleError` from one replica
        is retried on less-loaded candidates but — if nobody can make
        the deadline — surfaces AS the deadline error, never laundered
        into a queue-full shed."""
        now = time.monotonic()
        remaining = req.remaining(now)
        if remaining is not None and remaining <= 0:
            raise RequestTimeoutError(
                "request deadline elapsed before it could be placed "
                "on a replica")
        shed = infeasible = None
        breaker_skips = 0
        order, key = self._order_candidates(req.payload)
        for h in order:
            if exclude and h.name in exclude:
                continue
            if not h.breaker.allow(now):
                breaker_skips += 1
                self._count("breaker_skips")
                continue
            try:
                fut = h.engine.submit(req.payload, req.max_new_tokens,
                                      timeout=req.remaining(),
                                      eos_id=req.eos_id,
                                      priority=req.priority,
                                      route_hint=key
                                      if self.disaggregated else None,
                                      **req.sampling)
            except DeadlineInfeasibleError as e:
                # the deadline is the REQUEST's own constraint — a
                # less-loaded candidate may still make it; the breaker
                # is untouched (one impatient client must not open
                # breakers on healthy replicas), but a consumed
                # half-open probe slot is freed so the replica isn't
                # unroutable for a forfeited cooldown
                h.breaker.release_probe()
                self._count("deadline_sheds")
                infeasible = e
                continue
            except QueueFullError as e:
                self._count("sheds")
                h.breaker.record_failure(now)
                shed = e
                continue
            except (EngineCrashedError, EngineStoppedError) as e:
                h.breaker.record_failure(now)
                if isinstance(e, EngineCrashedError) and \
                        h.mark_dead(str(e)):
                    self._replica_death(h, str(e))
                continue
            except InvalidRequestError:
                h.breaker.release_probe()
                raise              # the request's own fault — no failover
            h.breaker.record_success()
            h.routed += 1
            self._count("routed")
            if not self.disaggregated:
                # residency follows placement: this replica is about
                # to prefill (and cache) the family's prefix.  In a
                # disaggregated fleet residency is created by adopt()
                # on the DECODE side — _place_decode publishes there.
                self._directory.publish(key, h.name)
            return h, fut
        if infeasible is not None:
            raise infeasible       # original deadline semantics, always
        if shed is not None or breaker_skips:
            # healthy replicas exist but ALL are saturated (shedding
            # now, or breaker-open from shedding moments ago).  Only a
            # FULL walk is saturation evidence: a hedge/failover probe
            # with replicas excluded never saw the whole fleet, and
            # partial evidence must not force brownout on the healthy
            # replicas it skipped.
            browned = self._note_saturation(now) if not exclude else False
            raise FleetSaturatedError(
                f"fleet {self.name!r}: all healthy replicas saturated "
                f"(breaker-open skips: {breaker_skips}) — back off or "
                "scale up"
                + ("; coordinated brownout engaged" if browned else ""))
        self._count("no_healthy")
        raise NoHealthyReplicaError(
            f"fleet {self.name!r}: no healthy replica accepted the "
            "request")

    def _note_saturation(self, now: float) -> bool:
        """Track all-replicas-shed submits; ``saturation_threshold``
        of them inside ``saturation_window`` seconds force every
        replica's overload controller to its brownout floor — the
        fleet degrades service coherently instead of each replica
        discovering the storm alone.  Returns True iff THIS call
        triggered the coordinated brownout."""
        if not self.saturation_brownout:
            return False
        with self._sat_lock:
            # threshold events must land inside ONE window — a sliding
            # check over the last N event times, not a gap-reset streak
            # (a trickle of one saturated submit every window-minus-ε
            # seconds must never read as a storm)
            self._sat_times.append(now)
            due = (len(self._sat_times) >= self.saturation_threshold
                   and now - self._sat_times[0] <= self.saturation_window
                   and now - self._sat_brownout_at
                   >= self.saturation_window)
            if due:
                self._sat_brownout_at = now
                self._sat_times.clear()
        if due:
            self._count("fleet_brownouts")
            fr = _fr_active()
            if fr is not None:
                fr.record("fleet.brownout", fleet=self.name)
            for h in self._healthy():
                try:
                    h.engine.force_brownout("fleet saturated")
                except Exception:
                    pass
        return due

    def _failover(self, req: _FleetRequest,
                  cause: BaseException) -> Tuple[ReplicaHandle, object]:
        """A replica failed the request mid-flight: resubmit elsewhere
        — within the ORIGINAL deadline and the bounded failover budget
        (neither is ever reset by a failover, so the fleet can never
        double-count a request's time or retries)."""
        if req.remaining() is not None and req.remaining() <= 0:
            raise RequestTimeoutError(
                "request deadline elapsed during replica failover") \
                from cause
        if req.failovers_left <= 0:
            self._count("failover_exhausted")
            raise cause
        # a faulted failover attempt aborts BEFORE the budget check —
        # the containment contract (resilience/faults.py) is that a
        # fleet.failover fault leaves budgets untouched
        try:
            _inject("fleet.failover")
        except BaseException:
            self._count("failover_faults")
            raise cause
        # the fleet-wide token bucket caps ADDED retry load across all
        # requests: when it is dry the original failure surfaces typed
        # — a replica crash during saturation must not fan out into a
        # resubmission herd (docs/overload.md)
        if not self._retry_budget.try_acquire():
            self._count("retry_budget_exhausted")
            raise cause
        req.failovers_left -= 1
        self._count("failovers")
        try:
            return self._submit_once(req)
        except ServingError as e:
            raise e from cause

    # ------------------------------------------------------------- submit
    def submit(self, x, max_new_tokens: Optional[int] = None,
               timeout: Optional[float] = None,
               eos_id: Optional[int] = None,
               priority: Optional[str] = None,
               temperature: float = 0.0, top_k: int = 0,
               top_p: float = 1.0, seed: int = 0) -> FleetFuture:
        """Enqueue one request on the fleet; same contract as
        ``InferenceEngine.submit`` with replica placement on top.
        ``timeout`` is the request's fleet-wide server deadline —
        failover resubmissions inherit the REMAINING time, never a
        fresh window.  ``priority`` (docs/overload.md) rides every
        attempt: a failed-over request keeps its class, and the
        sampling params (``temperature``/``top_k``/``top_p``/``seed``,
        docs/serving.md) ride too — seeded draws fold with absolute
        positions, so a failover or hedge reproduces the SAME stream
        on whichever replica wins."""
        if self._stopping:  # raceguard: unguarded(one-way stop flag: atomic bool read; the stop path itself serializes under _stop_lock)
            raise EngineStoppedError("fleet router is stopped")
        if self.mode == "decode":
            payload = onp.asarray(getattr(x, "asnumpy", lambda: x)(),
                                  dtype="int32")
            if payload.ndim == 2 and payload.shape[0] == 1:
                payload = payload[0]
        else:
            payload = onp.asarray(getattr(x, "asnumpy", lambda: x)())
        deadline = time.monotonic() + timeout if timeout else None
        # sampling params ride EVERY attempt unconditionally: the
        # replica engine owns validating them (a forward-mode engine
        # rejects non-defaults typed), so fleet and bare engine keep
        # one contract instead of the router silently dropping them
        req = _FleetRequest(payload, self.mode, max_new_tokens, eos_id,
                            deadline, self.max_failovers,
                            priority=priority,
                            sampling=dict(temperature=temperature,
                                          top_k=top_k, top_p=top_p,
                                          seed=seed))
        handle, inner = self._submit_once(req)
        return FleetFuture(self, req, handle, inner)

    def infer(self, x, max_new_tokens: Optional[int] = None,
              timeout: Optional[float] = None,
              eos_id: Optional[int] = None,
              priority: Optional[str] = None,
              temperature: float = 0.0, top_k: int = 0,
              top_p: float = 1.0, seed: int = 0):
        """Synchronous ``submit()`` + wait (unbounded client wait — the
        fleet resolves every future with a result or a typed error,
        same as the engine)."""
        if self._monitor is None:
            raise ServingError("router not started — call start() or use "
                               "the context manager")
        return self.submit(x, max_new_tokens, timeout, eos_id,
                           priority, temperature=temperature,
                           top_k=top_k, top_p=top_p,
                           seed=seed).result(None)

    # -------------------------------------------------------------- stats
    def _count(self, key: str, n: int = 1):
        with self._counters_lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def health(self) -> dict:
        reps = {}
        for h in self._members:
            try:
                eh = h.engine.health()
            except Exception as e:
                eh = {"live": False, "error": repr(e)}
            reps[h.name] = {"state": h.state, "deaths": h.total_deaths,
                            "suspects": h.total_suspects,
                            "restarts": h.restarts,
                            "breaker": h.breaker.state, "engine": eh}
        healthy = len(self._healthy())
        return {"name": self.name, "ready": healthy > 0
                and not self._stopping,  # raceguard: unguarded(one-way stop flag: atomic bool read; the stop path itself serializes under _stop_lock)
                "healthy": healthy, "replicas": reps}

    def stats(self) -> dict:
        """Fleet-wide snapshot: router counters, per-replica engine
        stats (CURRENT engines — a rebuilt replica starts fresh), and
        the aggregates a fleet dashboard fronts with (total throughput,
        fleet prefix hit rate)."""
        with self._counters_lock:
            router = dict(self._counters)
        replicas, agg = {}, {"submitted": 0, "completed": 0,
                             "tokens_generated": 0, "prefix_hits": 0,
                             "prefix_misses": 0, "prefix_tokens_saved": 0}
        for h in self._members:
            try:
                s = h.engine.stats()
            except Exception as e:
                replicas[h.name] = {"state": h.state, "error": repr(e)}
                continue
            replicas[h.name] = {"state": h.state, "deaths": h.total_deaths,
                                "suspects": h.total_suspects,
                                "restarts": h.restarts, "routed": h.routed,
                                "latency": h.latency.snapshot(),
                                "stats": s}
            agg["submitted"] += s["requests"]["submitted"]
            agg["completed"] += s["requests"]["completed"]
            agg["tokens_generated"] += s["tokens"]["tokens_generated"]
            for k in ("prefix_hits", "prefix_misses",
                      "prefix_tokens_saved"):
                agg[k] += s["prefix_cache"][k]
        looked = agg["prefix_hits"] + agg["prefix_misses"]
        agg["prefix_hit_rate"] = round(agg["prefix_hits"] / looked, 4) \
            if looked else None
        return {
            "fleet": {"name": self.name, "routing": self.routing,
                      "replicas": len(self._members),
                      "healthy": len(self._healthy()),
                      "spill_queue_depth": self.spill_queue_depth,
                      "max_failovers": self.max_failovers,
                      "tracked_prefixes": len(self._policy),
                      "disaggregated": self.disaggregated,
                      "roles": {h.name: h.role for h in self._members},
                      "directory": self._directory.stats(),
                      "gray": {"ejection": self.gray_ejection,
                               "multiplier": self.gray_multiplier,
                               "min_samples": self.gray_min_samples,
                               "window": self.gray_window},
                      "retry_budget": {
                          "available": round(
                              self._retry_budget.available, 2),
                          "burst": self._retry_budget.burst,
                          "rate": self._retry_budget.rate,
                          "denied": self._retry_budget.denied},
                      "breakers": {h.name: h.breaker.state
                                   for h in self._members}},
            "router": router,
            "aggregate": agg,
            "replicas": replicas,
        }

    # ----------------------------------------------------------- registry
    def _register_collector(self):
        """Publish fleet-level series into the process-wide registry
        (docs/observability.md) next to the replicas' own per-engine
        series.  Weakref-bound: a collected router prunes itself from
        the next scrape."""
        from ..observability.registry import default_registry
        ref = weakref.ref(self)

        def _samples():
            r = ref()
            if r is None:
                raise ReferenceError("FleetRouter collected")
            return r.registry_samples()

        default_registry().register_collector(f"fleet:{self.name}",
                                              _samples)

    def registry_samples(self) -> List[dict]:
        lbl = {"fleet": self.name}
        with self._counters_lock:
            counters = dict(self._counters)
        samples = [
            {"name": f"mxtpu_fleet_{k}_total", "kind": "counter",
             "labels": dict(lbl), "value": v, "help": ""}
            for k, v in sorted(counters.items())]
        healthy = 0
        hits = misses = 0
        for h in self._members:
            up = 1 if h.routable() else 0
            healthy += up
            rlbl = {"fleet": self.name, "replica": h.name}
            samples.append({"name": "mxtpu_fleet_replica_up",
                            "kind": "gauge", "labels": dict(rlbl),
                            "value": up, "help": ""})
            samples.append({"name": "mxtpu_fleet_replica_routed_total",
                            "kind": "counter", "labels": dict(rlbl),
                            "value": h.routed, "help": ""})
            samples.append({"name": "mxtpu_fleet_replica_restarts_total",
                            "kind": "counter", "labels": dict(rlbl),
                            "value": h.restarts, "help": ""})
            samples.append({"name": "mxtpu_fleet_replica_breaker_open",
                            "kind": "gauge", "labels": dict(rlbl),
                            "value": 0 if h.breaker.state == "closed"
                            else 1, "help": ""})
            # gray-failure visibility (docs/integrity.md): the same
            # per-replica latency signal the detector judges by, plus
            # the SUSPECT flag itself
            lat = h.latency.snapshot()
            samples.append({"name":
                            "mxtpu_fleet_replica_latency_ewma_seconds",
                            "kind": "gauge", "labels": dict(rlbl),
                            "value": round(lat["ewma"], 6), "help": ""})
            samples.append({"name":
                            "mxtpu_fleet_replica_latency_p99_seconds",
                            "kind": "gauge", "labels": dict(rlbl),
                            "value": round(lat["p99"], 6), "help": ""})
            samples.append({"name": "mxtpu_fleet_replica_suspect",
                            "kind": "gauge", "labels": dict(rlbl),
                            "value": 1 if h.state == SUSPECT else 0,
                            "help": ""})
            try:
                c = h.engine.metrics.counters
                hits += c["prefix_hits"]
                misses += c["prefix_misses"]
            except Exception:
                pass
        samples.append({"name": "mxtpu_fleet_replicas",
                        "kind": "gauge", "labels": dict(lbl),
                        "value": len(self._members), "help": ""})
        samples.append({"name": "mxtpu_fleet_replicas_healthy",
                        "kind": "gauge", "labels": dict(lbl),
                        "value": healthy, "help": ""})
        samples.append({"name": "mxtpu_fleet_retry_budget_available",
                        "kind": "gauge", "labels": dict(lbl),
                        "value": round(self._retry_budget.available, 2),
                        "help": ""})
        samples.append({"name": "mxtpu_fleet_directory_entries",
                        "kind": "gauge", "labels": dict(lbl),
                        "value": len(self._directory), "help": ""})
        looked = hits + misses
        if looked:
            samples.append({"name": "mxtpu_fleet_prefix_hit_rate",
                            "kind": "gauge", "labels": dict(lbl),
                            "value": round(hits / looked, 4), "help": ""})
        return samples

    def __repr__(self):
        return (f"FleetRouter({self.name!r}, routing={self.routing}, "
                f"replicas={len(self._members)}, "
                f"healthy={len(self._healthy())})")
