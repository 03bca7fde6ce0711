"""Overload control and graceful degradation (counterpart of
``mxnet_tpu/serving/overload.py``, the same classes, names and lock
sites).

The policy layer the serving engine (and, with ROADMAP queue A7, the
fleet router) consults so that sustained overload and retry storms
degrade service in a controlled, recoverable order:

- **Priority classes**: every request carries one of :data:`PRIORITIES`
  (``interactive`` > ``batch`` > ``best_effort``).  Batches form
  highest class first, and at depth an arriving request may evict the
  youngest queued request of a strictly lower class instead of being
  shed itself.
- **:class:`OverloadController`**: the brownout state machine, AIMD on
  queue depth against capacity and deadline misses.  Under pressure the
  degradation ``factor`` falls multiplicatively (1.0 → 0.5 → … →
  ``floor``); once pressure clears it recovers additively.  While
  ``factor < 1`` non-``interactive`` token budgets are capped at the
  factor and prefix inserts pause; only at the floor, with pressure
  still present, is the lowest class shed on arrival
  (``reason="brownout"``).
- **:class:`RetryBudget`**: a token bucket bounding the retry
  amplification (failover resubmissions, hedges) a router may add.
- **:class:`CircuitBreaker`**: per replica, consecutive failures open
  it for ``cooldown`` seconds, then one probe half-opens it.

All of it is host-side bookkeeping: no program's shape changes, so the
compile freeze after ``warmup()`` holds.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

from ..analysis.lockwitness import named_lock as _named_lock
from .errors import ServingError

__all__ = ["PRIORITIES", "PRIORITY_INTERACTIVE", "PRIORITY_BATCH",
           "PRIORITY_BEST_EFFORT", "priority_ordinal", "priority_name",
           "SHED_REASONS", "OverloadController", "RetryBudget",
           "CircuitBreaker"]

#: Priority classes, highest first.  Ordinal 0 is never token-capped or
#: brownout-shed; the last class is the only preemption victim and the
#: first to be shed.
PRIORITIES = ("interactive", "batch", "best_effort")
PRIORITY_INTERACTIVE = 0
PRIORITY_BATCH = 1
PRIORITY_BEST_EFFORT = 2

#: Every reason a request can be shed with (the ``reason`` label on the
#: ``mxtpu_serving_sheds_total`` counter and in ``stats()["overload"]``).
SHED_REASONS = ("queue_full", "deadline_infeasible", "priority_shed",
                "brownout")


def priority_ordinal(priority) -> int:
    """Map a class name (or ordinal) to its ordinal; raises on unknown
    classes so a typo'd priority fails the submit, not the scheduler."""
    if isinstance(priority, int):
        if not 0 <= priority < len(PRIORITIES):
            raise ServingError(f"priority ordinal out of range: {priority}")
        return priority
    try:
        return PRIORITIES.index(priority)
    except ValueError:
        raise ServingError(f"unknown priority {priority!r} — expected one "
                         f"of {PRIORITIES}") from None


def priority_name(ordinal: int) -> str:
    return PRIORITIES[ordinal]


class OverloadController:
    """AIMD brownout state machine.

    ``update()`` runs once per scheduler cycle on the engine thread;
    the submit-side queries (``cap_tokens`` / ``shedding`` /
    ``pause_inserts``) read plain attributes from caller threads — a
    torn read of a float is impossible under the GIL, and the policy
    tolerates one-cycle staleness by construction.

    Parameters
    ----------
    capacity : admission-queue capacity the pressure fractions are
        relative to.
    enabled : ``False`` pins ``factor`` at 1.0 forever (the blind-
        shedding baseline arm of the overload benchmark).
    enter_fraction : queue depth at or above this fraction of capacity
        counts as pressure (as does any deadline miss since the last
        cycle).
    exit_fraction : recovery only starts once depth falls to this
        fraction AND ``hold`` seconds have passed without pressure.
    decrease : multiplicative factor per pressure interval (AIMD "MD").
    recover_step : additive factor per recovery interval (AIMD "AI").
    floor : lowest the factor goes; at the floor with pressure still
        present the controller hard-sheds the lowest class.
    interval : minimum seconds between factor changes (a decode cycle
        is sub-millisecond; unthrottled MD would hit the floor in one
        burst).
    hold : seconds of no-pressure required before recovery starts.
    """

    def __init__(self, capacity: int, *, enabled: bool = True,
                 enter_fraction: float = 0.75,
                 exit_fraction: float = 0.25,
                 decrease: float = 0.5, recover_step: float = 0.25,
                 floor: float = 0.25, interval: float = 0.05,
                 hold: float = 0.2):
        self.capacity = max(1, int(capacity))
        self.enabled = bool(enabled)
        self.enter_fraction = float(enter_fraction)
        self.exit_fraction = float(exit_fraction)
        self.decrease = float(decrease)
        self.recover_step = float(recover_step)
        self.floor = float(floor)
        self.interval = float(interval)
        self.hold = float(hold)
        if not (0.0 < self.floor <= 1.0):
            raise ServingError(f"floor must be in (0, 1], got {self.floor}")
        self.factor = 1.0
        # fleet-coordinated cap: an
        # external controller with AGGREGATE visibility (the fleet
        # autoscaler) can cap the effective factor across replicas.
        # It composes with — never replaces — the local AIMD loop:
        # effective_factor = min(factor, fleet_cap), so a hot replica
        # still browns out alone, and the fleet only degrades together
        # when the aggregate signals say so.
        self.fleet_cap = 1.0
        self.brownouts = 0           # lifetime brownout entries
        self._last_change = 0.0
        self._last_pressure: Optional[float] = None

    # ---------------------------------------------------------------- tick
    def update(self, queue_depth: int, deadline_misses: int,
               now: Optional[float] = None) -> bool:
        """One controller tick.  Returns True iff this tick ENTERED
        brownout (factor left 1.0) — the engine counts entries."""
        if not self.enabled:
            return False
        now = time.monotonic() if now is None else now
        pressure = (queue_depth >= self.enter_fraction * self.capacity
                    or deadline_misses > 0)
        entered = False
        if pressure:
            self._last_pressure = now
            if now - self._last_change >= self.interval:
                nf = max(self.floor, self.factor * self.decrease)
                if nf < self.factor:
                    entered = self.factor >= 1.0
                    self.factor = nf
                    self._last_change = now
                    if entered:
                        self.brownouts += 1
        elif (self.factor < 1.0
              and queue_depth <= self.exit_fraction * self.capacity
              and (self._last_pressure is None
                   or now - self._last_pressure >= self.hold)
              and now - self._last_change >= self.interval):
            self.factor = min(1.0, self.factor + self.recover_step)
            self._last_change = now
        return entered

    def force(self, now: Optional[float] = None) -> None:
        """Externally slam the controller to the floor — the fleet
        router's coordinated-brownout path when every replica is
        saturated.  Recovery is automatic via ``update()``."""
        if not self.enabled:
            return
        now = time.monotonic() if now is None else now
        if self.factor >= 1.0:
            self.brownouts += 1
        self.factor = self.floor
        self._last_pressure = now
        self._last_change = now

    def set_fleet_cap(self, cap: float) -> bool:
        """Externally cap the effective factor — the autoscaler's
        fleet-coordinated brownout knob, driven from AGGREGATE signals
        so one hot replica cannot drag idle siblings down.  Clamped to
        ``[floor, 1.0]``; 1.0 releases the cap (local AIMD recovery is
        untouched either way).  Returns True iff this call ENTERED
        brownout (the caller counts entries, like ``update()``)."""
        if not self.enabled:
            return False
        cap = min(1.0, max(self.floor, float(cap)))
        was = self.brownout
        self.fleet_cap = cap
        entered = not was and self.brownout
        if entered:
            self.brownouts += 1
        return entered

    # ------------------------------------------------------------- queries
    @property
    def effective_factor(self) -> float:
        """What the engine actually degrades by: the local AIMD factor
        under the fleet-coordinated cap."""
        return min(self.factor, self.fleet_cap)

    @property
    def brownout(self) -> bool:
        return self.effective_factor < 1.0

    def cap_tokens(self, ordinal: int, requested: int) -> int:
        """Brownout token cap: non-``interactive`` classes get the
        effective factor of their ask (never below 1).  Service
        degrades before anything is refused."""
        if not self.brownout or ordinal == PRIORITY_INTERACTIVE:
            return requested
        return max(1, int(round(requested * self.effective_factor)))

    def shedding(self, ordinal: int,
                 now: Optional[float] = None) -> bool:
        """Hard brownout shedding: only the LOWEST class, only at the
        floor, only while pressure is recent — everything milder is
        handled by degradation, not refusal.  A fleet cap AT the floor
        sheds without the local-pressure recency test: the aggregate
        signals already established standing pressure fleet-wide, and
        an idle-looking replica must still refuse best-effort work the
        fleet as a whole cannot afford."""
        if not self.enabled or ordinal != len(PRIORITIES) - 1:
            return False
        if self.fleet_cap <= self.floor:
            return True
        if self.factor > self.floor:
            return False
        now = time.monotonic() if now is None else now
        return (self._last_pressure is not None
                and now - self._last_pressure < self.hold)

    @property
    def pause_inserts(self) -> bool:
        """Brownout pauses NEW prefix-pool inserts (each costs a
        compiled row copy); preemption parking bypasses this — parking
        is what makes preemption nearly free."""
        return self.brownout

    def snapshot(self) -> dict:
        return {"enabled": self.enabled,
                "factor": round(self.factor, 4),
                "fleet_cap": round(self.fleet_cap, 4),
                "effective_factor": round(self.effective_factor, 4),
                "brownout": self.brownout,
                "brownouts": self.brownouts,
                "floor": self.floor,
                "capacity": self.capacity}

    def __repr__(self):
        return (f"OverloadController(factor={self.factor:.3f}, "
                f"capacity={self.capacity}, "
                f"brownouts={self.brownouts})")


class RetryBudget:
    """Token bucket bounding fleet-added retry amplification.

    ``burst`` tokens are available immediately; they refill at ``rate``
    per second.  Every failover resubmission and every hedge must
    ``try_acquire()`` a token first — when the bucket is dry the
    original failure surfaces typed (failover) or the hedge is skipped,
    so N clients retrying into an overloaded fleet can add at most
    ``burst + rate * t`` extra submits, never a multiplicative herd.
    Thread-safe (submit paths race)."""

    def __init__(self, rate: float = 2.0, burst: int = 8):
        self.rate = float(rate)
        self.burst = float(burst)
        if self.rate < 0 or self.burst < 1:
            raise ServingError(f"need rate >= 0 and burst >= 1, got "
                             f"rate={rate}, burst={burst}")
        self._tokens = self.burst
        self._t: Optional[float] = None
        self._lock = _named_lock("fleet.retry_budget",
                                 "failover/hedge token bucket")
        self.denied = 0              # lifetime try_acquire failures

    def _refill(self, now: float) -> None:  # guarded-by: _lock
        """Lazy time-based top-up (caller holds the lock).  The refill
        clock never rewinds: a caller passing a stale ``now`` must not
        cause the same interval to refill twice."""
        if self._t is not None and now > self._t:
            self._tokens = min(self.burst,
                               self._tokens + (now - self._t) * self.rate)
        self._t = now if self._t is None else max(self._t, now)

    def try_acquire(self, n: float = 1.0,
                    now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._refill(now)
            if self._tokens >= n:
                self._tokens -= n
                return True
            self.denied += 1
            return False

    def refund(self, n: float = 1.0) -> None:
        """Return a token acquired for retry load that was never
        actually placed (e.g. a hedge whose placement found the whole
        fleet saturated) — otherwise phantom retries drain the budget
        real failover resubmissions need."""
        with self._lock:
            self._tokens = min(self.burst, self._tokens + n)

    @property
    def available(self) -> float:
        with self._lock:
            self._refill(time.monotonic())
            return self._tokens

    def __repr__(self):
        return (f"RetryBudget(rate={self.rate}, burst={self.burst}, "
                f"available={self.available:.2f}, "
                f"denied={self.denied})")


class CircuitBreaker:
    """Per-replica breaker: ``threshold`` consecutive failures (sheds
    or replica-level submit errors) OPEN it; while open the router
    skips the replica; after ``cooldown`` seconds it half-opens — ONE
    request is the probe (concurrent callers keep getting False until
    its outcome lands), and that outcome closes or re-opens the
    breaker.  A probe whose caller vanishes without reporting forfeits
    the slot after a further ``cooldown``.  Thread-safe."""

    def __init__(self, threshold: int = 5, cooldown: float = 0.5):
        self.threshold = max(1, int(threshold))
        self.cooldown = float(cooldown)
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._probe_at: Optional[float] = None
        self._lock = _named_lock("fleet.circuit_breaker",
                                 "per-replica breaker state")
        self.opens = 0               # lifetime open transitions

    def allow(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            if self._opened_at is None:
                return True
            if now - self._opened_at < self.cooldown:
                return False
            # half-open: admit exactly one probe at a time — N callers
            # racing past the cooldown must not re-amplify the very
            # load the breaker opened against
            if self._probe_at is not None \
                    and now - self._probe_at < self.cooldown:
                return False
            self._probe_at = now
            return True

    def record_failure(self, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._failures += 1
            self._probe_at = None
            if self._failures >= self.threshold:
                if self._opened_at is None:
                    self.opens += 1
                self._opened_at = now    # (re-)open; half-open probe failed

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probe_at = None

    def release_probe(self) -> None:
        """The half-open probe's outcome was the REQUEST's own fault
        (infeasible deadline, invalid payload) — no evidence either
        way about the replica.  Free the probe slot without closing or
        re-opening the breaker so the next caller can probe now
        instead of waiting out a forfeited cooldown."""
        with self._lock:
            self._probe_at = None

    @property
    def state(self) -> str:
        now = time.monotonic()
        with self._lock:
            if self._opened_at is None:
                return "closed"
            return "half_open" if now - self._opened_at >= self.cooldown \
                else "open"

    def __repr__(self):
        return (f"CircuitBreaker(state={self.state}, "
                f"opens={self.opens})")
