"""Serving error taxonomy (counterpart of ``mxnet_tpu/serving/errors.py``,
the same classes and bases).

Every failure a request can see is a typed subclass of
:class:`ServingError`, so callers can distinguish "shed under load —
retry elsewhere" (:class:`QueueFullError`), "missed its deadline"
(:class:`RequestTimeoutError`), "engine going away"
(:class:`EngineStoppedError`) and "request itself is malformed"
(:class:`InvalidRequestError`).  Load shedding happens at ``submit()``
time against a bounded queue.  The fleet raises
:class:`NoHealthyReplicaError` and :class:`FleetSaturatedError`; KV
migration and the tiers' seeds raise :class:`MigrationError` and
:class:`MigrationDigestError`.
"""
from __future__ import annotations

from ..base import MXNetError

__all__ = ["ServingError", "QueueFullError", "RequestTimeoutError",
           "DeadlineExceededError", "DeadlineInfeasibleError",
           "EngineStoppedError", "EngineCrashedError",
           "InvalidRequestError", "NonFiniteOutputError",
           "NoHealthyReplicaError", "RequestCancelledError",
           "FleetSaturatedError", "MigrationError",
           "MigrationDigestError"]


class ServingError(MXNetError):
    """Base class for all online-inference failures."""


class QueueFullError(ServingError):
    """Backpressure: the bounded request queue is at its configured
    depth; the request was shed WITHOUT being enqueued."""


class RequestTimeoutError(ServingError):
    """The request's deadline elapsed — while queued (including while
    the engine drains toward a stop), or mid-generation (a partially
    generated sequence is discarded and its KV slot freed)."""


#: Canonical deadline-error name; ``RequestTimeoutError`` is the
#: historical alias — they are the same class, so either catches both.
DeadlineExceededError = RequestTimeoutError


class DeadlineInfeasibleError(RequestTimeoutError):
    """Deadline-aware admission: given the observed
    queue wait plus prefill/decode latency estimates, this request's
    deadline cannot be met — it is rejected ON ARRIVAL instead of
    burning a queue slot (and the scheduler's time) on work that is
    doomed to time out.  A subclass of :class:`RequestTimeoutError`:
    clients that handle deadline errors handle this one."""


class RequestCancelledError(ServingError):
    """The request was actively cancelled before completing — e.g. the
    fleet router reclaiming the losing copy of a hedged request once
    the winner resolved (dequeued if still queued; its KV slot freed if
    mid-decode).  Distinct from :class:`EngineStoppedError`: the engine
    is fine, the caller just no longer wants the answer."""


class EngineStoppedError(ServingError):
    """The engine is stopped/stopping and not accepting (or no longer
    able to finish) this request."""


class EngineCrashedError(ServingError):
    """The scheduler thread died or hung: the watchdog condemned the
    engine and failed every queued and in-flight request with this error
    so no caller blocks on a future that can never resolve.  The engine
    cannot be restarted — build a fresh one.

    ``engine`` names the engine that actually crashed.  This matters in
    a disaggregated fleet: a request routed to a prefill replica can
    die on the DECODE replica that adopted it, and the router must mark
    the right corpse dead when it fails the request over."""

    def __init__(self, *args, engine=None):
        super().__init__(*args)
        self.engine = engine


class InvalidRequestError(ServingError):
    """The request can never be served by this engine configuration
    (e.g. prompt longer than the largest sequence bucket, or
    prompt + max_new_tokens exceeding the KV cache length)."""


class NoHealthyReplicaError(ServingError):
    """The fleet router has no replica it can
    route to: every :class:`ReplicaHandle` is dead, draining, or sitting
    out a probation window.  Distinct from :class:`QueueFullError` —
    which the router raises when healthy replicas exist but ALL of them
    shed the request — so callers can tell "scale up / wait out
    probation" apart from "back off, the fleet is saturated"."""


class FleetSaturatedError(QueueFullError):
    """Every healthy replica in the fleet shed the request (queue at
    depth or circuit breaker open) — the fleet as a whole is saturated.
    A subclass of :class:`QueueFullError` (the back-off signal is the
    same) that additionally tells the caller the condition is
    fleet-wide: the router has triggered coordinated brownout on the
    replicas and scale-up, not retry, is the fix."""


class MigrationError(ServingError):
    """A disaggregated prefill→decode handoff could not be completed: the decode-role
    engine refused the bundle (role/layout/capacity mismatch, no free
    slot or pages) or the transport faulted.  The request is NOT lost —
    the prefill-role engine catches this and finishes the request
    itself (colocated fallback), so callers only ever see it from a
    direct :meth:`InferenceEngine.adopt` call."""


class MigrationDigestError(MigrationError):
    """The migration bundle's BLAKE2b tree digest did not match its
    payload: the transfer was torn or the arrays were mutated in
    flight.  Raised BEFORE the decode engine claims any slot or page —
    a corrupt bundle is never adopted and the decode pool is left
    pristine."""


class NonFiniteOutputError(ServingError):
    """The model produced NaN/Inf for THIS request (non-finite logits
    in a prefill/decode step, or a non-finite forward output row).  The
    request fails typed, its KV slot is freed, and the engine keeps
    serving the rest of the batch — a numerics fault in one request's
    data must not read as an engine crash or trip the watchdog
    ."""
