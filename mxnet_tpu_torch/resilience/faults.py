"""Deterministic fault injection for chaos testing (counterpart of
``mxnet_tpu/resilience/faults.py``: the same sites, actions and seeded
schedule, so one plan fires on the same hits in both packages).

The rest of the codebase calls :func:`inject(site)` at named *injection
sites* on its hot paths (``"serving.decode_step"``, ``"serving.prefill"``,
``"serving.prefix_lookup"`` / ``"serving.prefix_copy"`` (the prefix
cache's host radix-tree ops and device row copies — the engine degrades
those to a cache miss and disables the cache on repeated faults),
``"trainer.step"``, ``"checkpoint.save"``, ``"kvstore.push"``, the
fleet router's ``"fleet.route"`` / ``"fleet.failover"`` /
``"fleet.drain"`` (:mod:`mxnet_tpu_torch.fleet` — route faults degrade to
least-loaded placement, failover faults abort that failover attempt,
and a delay at ``fleet.drain`` models a replica hanging in drain, which
fleet shutdown must condemn rather than wait out), and the overload
controller's ``"overload.admission"`` / ``"overload.preempt"``
(docs/overload.md — an admission fault degrades to ADMITTING the
request, its deadline still enforced downstream; a preempt fault aborts
that preemption attempt, the victim keeps decoding — overload control
is an optimization layer and must never fail a request itself), …).
With
no plan active that
call is one module-global load plus a ``None`` check — provably in the
noise of any step that launches device work.  Inside a
``with FaultPlan(...):`` block each call counts a *hit* per site and
fires whatever the plan registered for that hit:

- ``raise_at``  — raise an exception (:class:`InjectedFault` by default;
  pass ``retryable=True`` for :class:`RetryableFault`, which the serving
  engine and :class:`~mxnet_tpu_torch.resilience.ResilientLoop` treat as
  transient and retry with bounded backoff);
- ``delay_at``  — sleep, simulating a slow or hung step (what a
  serving watchdog must detect);
- ``kill_at``   — raise :class:`SimulatedPreemption`, a ``BaseException``
  that models SIGKILL/host preemption: generic ``except Exception``
  recovery must NOT swallow it;
- ``call_at``   — run an arbitrary callback (e.g. ``os.kill(os.getpid(),
  SIGTERM)`` to exercise a real signal path at a deterministic step);
- ``nonfinite_at`` — *numeric* faults: instead of raising, the site's
  :func:`poison` query returns NaN/Inf, which the caller splices into
  its computation (``trainer.grad_nonfinite`` / ``trainer.loss_nonfinite``
  poison gradients/loss inside the guarded training step,
  ``io.bad_batch`` corrupts an input batch before iterator-level
  quarantine).  The training-health guardrails (docs/guardrails.md)
  must contain these exactly like ResilientLoop contains kills.
- ``corrupt_at`` — *state* faults: like ``nonfinite_at`` this never
  raises; the site's :func:`poison` query fires and the caller corrupts
  its own durable state (``checkpoint.corrupt`` flips bytes in the
  just-committed checkpoint file, simulating post-commit bit rot that
  the verified-restore path — docs/integrity.md — must detect,
  quarantine, and fall back across).

Sites can additionally be *scoped*: callers that own a natural identity
(each serving engine passes its claimed name) fire BOTH the plain site
and ``"<site>@<scope>"``, so a plan can target one replica of a fleet —
``delay_at("serving.decode_step@fleet-r1", every=1, seconds=0.1)``
models exactly the gray failure (slow but health-passing replica) the
fleet's SUSPECT ejection exists to catch.  The disabled hot path still
pays only one global load + ``None`` check.

Firing is deterministic: ``at=N`` fires on the Nth hit of the site
(1-based), ``every=K`` on every Kth, and ``prob=p`` draws from a
``random.Random(seed)`` owned by the plan — the same seed always yields
the same fault schedule.  Plans are context-manager scoped and
process-global (the serving scheduler thread must see the plan the test
thread activated); nesting raises.  ``plan.log`` records every fired
fault as ``(site, hit, action)`` so tests and
chaos harnesses can assert the schedule actually executed.
"""
from __future__ import annotations

import random as _pyrandom
import re
import threading
import time
from typing import Callable, List, Optional, Tuple

from ..analysis.lockwitness import named_lock as _named_lock
from ..base import MXNetError

__all__ = ["FaultPlan", "FaultSpec", "InjectedFault", "RetryableFault",
           "SimulatedPreemption", "UnknownFaultSiteError", "inject",
           "poison", "active_plan", "register_site", "known_sites",
           "KNOWN_SITES"]


class InjectedFault(MXNetError):
    """An exception raised on purpose by an active :class:`FaultPlan`."""


class UnknownFaultSiteError(MXNetError):
    """A :class:`FaultPlan` targeted a site nobody registered.

    Before this error existed a typo'd site (``"serving.decode_setp"``)
    built a plan that silently never fired — dead chaos coverage that
    LOOKED like a passing test.  Sites are now declared centrally in
    :data:`KNOWN_SITES` (or by callers via :func:`register_site`) and
    plan builders reject anything else at build time, where the typo is
    one stack frame from its author."""


class RetryableFault(InjectedFault):
    """A transient injected failure: retry-with-backoff is the correct
    response (the serving engine and ResilientLoop both honor it)."""


class SimulatedPreemption(BaseException):
    """Models abrupt process death (host preemption, SIGKILL, OOM-kill).

    Deliberately a ``BaseException``: recovery code that catches plain
    ``Exception`` must not be able to "survive" a kill — only a fresh
    process (or the test harness standing in for one) resumes from the
    last committed checkpoint.
    """


# --------------------------------------------------------------- site registry
#
# The central declaration of every injection site, the reference's
# list (``mxnet_tpu/resilience/faults.py``) whether or not the port
# has the caller yet: plan builders check that every TARGETED site is
# declared, so a typo'd site fails where it is written.
KNOWN_SITES: dict = {}

_SITE_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")


def register_site(site: str, doc: str = "") -> str:
    """Declare an injection site (idempotent; returns ``site``).

    Sites are dotted lowercase paths (``"subsystem.event"``).  The
    in-tree sites below are registered at import; tests and downstream
    code exercising the fault machinery with their own sites must
    register them first — that is the point: a site nobody declared is
    a site nobody instruments."""
    if not _SITE_RE.match(site):
        raise MXNetError(
            f"invalid fault site name {site!r}: want dotted lowercase "
            f"like 'serving.decode_step'")
    KNOWN_SITES.setdefault(site, doc)
    return site


def known_sites() -> tuple:
    """Sorted snapshot of every registered site."""
    return tuple(sorted(KNOWN_SITES))


def _site_base(site: str) -> str:
    """Strip the ``@<scope>`` suffix a scoped plan targets."""
    return site.split("@", 1)[0]


def _check_site(site: str) -> str:
    if not isinstance(site, str) or _site_base(site) not in KNOWN_SITES:
        raise UnknownFaultSiteError(
            f"unknown fault site {site!r}: not in faults.KNOWN_SITES — "
            f"a plan targeting it would silently never fire; declare it "
            f"with faults.register_site() (known: "
            f"{', '.join(known_sites())})")
    return site


# serving engine (docs/serving.md, docs/resilience.md)
register_site("serving.scheduler", "top of every scheduler cycle")
register_site("serving.prefill", "batched full/chunked prefill dispatch")
register_site("serving.decode_step", "batched decode-step dispatch")
register_site("serving.forward", "batched forward-mode dispatch")
register_site("serving.prefix_lookup", "prefix-cache host radix-tree ops")
register_site("serving.prefix_copy", "prefix-cache compiled row copy")
register_site("serving.page_alloc",
              "paged-KV page allocation (degrades to an alloc retry)")
register_site("serving.page_copy",
              "paged-KV compiled partial-tail-page copy (degrades to "
              "whole-page sharing + longer suffix prefill)")
register_site("serving.draft", "speculative draft dispatch (degrades "
              "that cycle to plain one-token decode)")
register_site("serving.verify", "speculative verify dispatch (degrades "
              "that cycle to plain one-token decode — the read-only "
              "drafter left nothing to clean up)")
register_site("serving.draft_logits",
              "poison: NaN/Inf splice into the draft head's logits "
              "(proposals go garbage; verify rejects them — tokens "
              "stay correct, only speed degrades)")
register_site("serving.migrate_out",
              "disaggregated prefill→decode KV export (degrades to "
              "colocated fallback: the prefill engine finishes the "
              "request itself, no rider retry budget charged)")
register_site("serving.migrate_in",
              "disaggregated decode-side adopt ingress (fires BEFORE "
              "any slot/page claim — a refused bundle leaves the "
              "decode pool pristine and the prefill side degrades to "
              "colocated fallback)")
register_site("serving.tier_demote",
              "tiered prefix cache device→host spill, on the tier "
              "worker BEFORE the host copy (a failed demotion just "
              "drops the bundle — the entry evicts exactly as without "
              "the tier, nothing is lost)")
register_site("serving.tier_promote",
              "tiered prefix cache host→device promotion, on the tier "
              "worker BEFORE the digest verify and upload (a failed "
              "promotion degrades to a counted tier miss — the request "
              "recomputes its prefill, tokens stay correct)")
register_site("serving.tier_rot",
              "poison: post-seal byte flips in a demoted KV bundle "
              "(host-RAM bit rot; verify-on-promote rejects the bundle "
              "— a rotted spill degrades to a counted miss, never a "
              "poisoned slot)")
register_site("serving.kv_quant",
              "int8 quantize-on-write gate, fired at the top of every "
              "prefill dispatch on a quantized engine BEFORE any device "
              "work (a failed quantize degrades to a counted recompute: "
              "the batch sits out one cycle and retries, slots/pages/"
              "table untouched — never a torn int8 write)")
register_site("serving.kv_scale",
              "poison: NaN splice into one claimed page's fp32 scale "
              "sidecar (host-RAM rot in the dequant path; the in-graph "
              "NaN guard detects it at the first dequant that reads the "
              "page — the victim fails typed, its pages go through the "
              "ordinary dirty-page scrub, a counted dequant fault, "
              "never a poisoned pool)")
# overload control (docs/overload.md) — degrades, never fails a request
register_site("overload.admission", "priority/deadline admission gate")
register_site("overload.preempt", "slot-preemption attempt")
# training (docs/resilience.md, docs/guardrails.md)
register_site("trainer.step", "ShardedTrainer compiled step")
register_site("trainer.loss_nonfinite", "poison: loss NaN/Inf splice")
register_site("trainer.grad_nonfinite", "poison: gradient NaN/Inf splice")
register_site("io.bad_batch", "poison: corrupt an input batch")
# checkpointing (docs/resilience.md, docs/integrity.md)
register_site("checkpoint.save", "AtomicCheckpointer serialize phase")
register_site("checkpoint.commit", "AtomicCheckpointer commit rename")
register_site("checkpoint.restore", "checkpoint restore/deserialize")
register_site("checkpoint.corrupt", "poison: post-commit bit rot")
register_site("serialization.commit", "utils.serialization atomic replace")
# kvstore
register_site("kvstore.push", "kvstore push RPC")
register_site("kvstore.pull", "kvstore pull RPC")
# fleet tier (docs/fleet.md)
register_site("fleet.route", "placement decision (degrades least-loaded)")
register_site("fleet.failover", "one failover attempt (budget untouched)")
register_site("fleet.drain", "replica drain (delay models a hang)")
register_site("fleet.scale_up", "elastic scale-up action (degrades to "
              "no-op before any engine is built)")
register_site("fleet.scale_down", "elastic scale-down action (degrades "
              "to no-op before the victim starts draining)")
# data pipeline (docs/data.md)
register_site("data.prefetch", "top of each DevicePrefetcher feed cycle, "
              "before the source read (degrades that batch to a "
              "synchronous host hand-off; a kill crashes the feeder and "
              "the consumer takes over at the clean offset)")
register_site("data.device_put", "feeder device placement (retried once, "
              "then the batch falls back to host arrays)")
register_site("data.bad_shard", "poison: corrupt one host's shard of the "
              "global batch (quarantined + counted skip, never trained "
              "on)")


class FaultSpec:
    """One registered fault: where, when, and what."""

    __slots__ = ("site", "action", "at", "every", "prob", "exc", "seconds",
                 "fn", "value", "max_fires", "fires")

    def __init__(self, site: str, action: str, *, at: Optional[int] = None,
                 every: Optional[int] = None, prob: Optional[float] = None,
                 exc: Optional[BaseException] = None, seconds: float = 0.0,
                 fn: Optional[Callable] = None, value: float = float("nan"),
                 max_fires: Optional[int] = None):
        if action not in ("raise", "delay", "kill", "call", "corrupt"):
            raise MXNetError(f"unknown fault action {action!r}")
        if sum(x is not None for x in (at, every, prob)) != 1:
            raise MXNetError("exactly one of at=/every=/prob= must be set")
        self.site = _check_site(site)
        self.action = action
        self.at = at
        self.every = every
        self.prob = prob
        self.exc = exc
        self.seconds = seconds
        self.fn = fn
        self.value = float(value)
        # `at` fires once by definition; recurring triggers default unbounded
        self.max_fires = 1 if at is not None and max_fires is None \
            else max_fires
        self.fires = 0

    def should_fire(self, hit: int, rng: _pyrandom.Random) -> bool:
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.at is not None:
            return hit == self.at
        if self.every is not None:
            return hit % self.every == 0
        return rng.random() < self.prob

    def __repr__(self):
        when = (f"at={self.at}" if self.at is not None else
                f"every={self.every}" if self.every is not None else
                f"prob={self.prob}")
        return f"FaultSpec({self.site!r}, {self.action}, {when})"


# The one active plan.  Written only under _PLAN_LOCK; read lock-free on
# the hot path (a torn read is impossible for a single reference).
_ACTIVE: Optional["FaultPlan"] = None
_PLAN_LOCK = _named_lock("faults.plan_global", "active-plan swaps")


class FaultPlan:
    """A seeded, scoped schedule of faults across injection sites.

    Builder methods chain::

        plan = (FaultPlan(seed=7)
                .kill_at("trainer.step", at=3)
                .raise_at("serving.decode_step", at=2, retryable=True)
                .delay_at("serving.forward", every=10, seconds=0.5))
        with plan:
            ...   # faults fire; plan.log records them

    Hit counters live on the plan, so a plan that stays active across a
    kill/resume cycle keeps counting — "kill at hits 3, 7 and 10" lands
    on three *distinct* steps even though the killed step is replayed.
    """

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._rng = _pyrandom.Random(self.seed)
        self._lock = _named_lock("faults.plan", "per-plan hit counters")
        self.specs: List[FaultSpec] = []
        self.hits: dict = {}
        self.log: List[Tuple[str, int, str]] = []

    # ------------------------------------------------------------- builders
    def raise_at(self, site: str, *, at: Optional[int] = None,
                 every: Optional[int] = None, prob: Optional[float] = None,
                 exc: Optional[BaseException] = None,
                 retryable: bool = False,
                 max_fires: Optional[int] = None) -> "FaultPlan":
        if exc is None:
            cls = RetryableFault if retryable else InjectedFault
            exc = cls(f"injected fault at {site}")
        self.specs.append(FaultSpec(site, "raise", at=at, every=every,
                                    prob=prob, exc=exc,
                                    max_fires=max_fires))
        return self

    def delay_at(self, site: str, seconds: float, *,
                 at: Optional[int] = None, every: Optional[int] = None,
                 prob: Optional[float] = None,
                 max_fires: Optional[int] = None) -> "FaultPlan":
        self.specs.append(FaultSpec(site, "delay", at=at, every=every,
                                    prob=prob, seconds=float(seconds),
                                    max_fires=max_fires))
        return self

    def kill_at(self, site: str, *, at: Optional[int] = None,
                every: Optional[int] = None, prob: Optional[float] = None,
                max_fires: Optional[int] = None) -> "FaultPlan":
        self.specs.append(FaultSpec(site, "kill", at=at, every=every,
                                    prob=prob, max_fires=max_fires))
        return self

    def call_at(self, site: str, fn: Callable, *, at: Optional[int] = None,
                every: Optional[int] = None, prob: Optional[float] = None,
                max_fires: Optional[int] = None) -> "FaultPlan":
        self.specs.append(FaultSpec(site, "call", at=at, every=every,
                                    prob=prob, fn=fn, max_fires=max_fires))
        return self

    def nonfinite_at(self, site: str, *, at: Optional[int] = None,
                     every: Optional[int] = None,
                     prob: Optional[float] = None,
                     value: float = float("nan"),
                     max_fires: Optional[int] = None) -> "FaultPlan":
        """Register a NUMERIC fault: the site's :func:`poison` query
        returns ``value`` (NaN by default, ``float('inf')`` for overflow
        storms) on the scheduled hits.  Unlike the raising actions this
        never throws — the caller owns splicing the value into its
        data/loss/gradients, which is what makes the fault land *inside*
        the computation the guardrails must contain."""
        if not (value != value or value in (float("inf"), float("-inf"))):
            raise ValueError(
                f"nonfinite_at needs a non-finite value, got {value!r}")
        self.specs.append(FaultSpec(site, "corrupt", at=at, every=every,
                                    prob=prob, value=value,
                                    max_fires=max_fires))
        return self

    def corrupt_at(self, site: str, *, at: Optional[int] = None,
                   every: Optional[int] = None,
                   prob: Optional[float] = None,
                   max_fires: Optional[int] = None) -> "FaultPlan":
        """Register a STATE-corruption fault: the site's :func:`poison`
        query fires (returns a sentinel value) and the caller corrupts
        its own durable state — e.g. ``checkpoint.corrupt`` flips bytes
        in the file a save just committed.  Never raises at the site:
        real bit rot doesn't announce itself either."""
        self.specs.append(FaultSpec(site, "corrupt", at=at, every=every,
                                    prob=prob, max_fires=max_fires))
        return self

    # -------------------------------------------------------------- firing
    def fire(self, site: str):
        """Count a hit at ``site`` and execute whatever is due.  Called
        from :func:`inject`; any thread.  ``corrupt`` specs never fire
        here — they are value queries, consumed via :func:`poison`."""
        with self._lock:
            hit = self.hits.get(site, 0) + 1
            self.hits[site] = hit
            due = [s for s in self.specs
                   if s.site == site and s.action != "corrupt"
                   and s.should_fire(hit, self._rng)]
            for s in due:
                s.fires += 1
                self.log.append((site, hit, s.action))
        # act OUTSIDE the lock: a delay must not serialize other sites,
        # and a raised fault must not leave the plan lock held
        for s in due:
            if s.action == "delay":
                time.sleep(s.seconds)
            elif s.action == "call":
                s.fn()
            elif s.action == "kill":
                raise SimulatedPreemption(
                    f"simulated preemption at {site} (hit {hit})")
            else:
                # a FRESH instance per fire: raising the same object from
                # recurring specs (every=/prob=) would share mutable
                # __traceback__/__context__ across fires and threads
                try:
                    exc = type(s.exc)(*s.exc.args)
                except Exception:
                    exc = s.exc
                raise exc

    def poison_value(self, site: str) -> Optional[float]:
        """Count a hit at ``site`` and return the due ``corrupt`` value
        (or ``None``).  The raising counterpart of :meth:`fire` for
        numeric-fault sites; a site should be either raise-style or
        poison-style, not both."""
        with self._lock:
            hit = self.hits.get(site, 0) + 1
            self.hits[site] = hit
            val = None
            for s in self.specs:
                if s.site == site and s.action == "corrupt" \
                        and s.should_fire(hit, self._rng):
                    s.fires += 1
                    self.log.append((site, hit, "corrupt"))
                    val = s.value
        return val

    # -------------------------------------------------------------- scoping
    def __enter__(self) -> "FaultPlan":
        global _ACTIVE
        with _PLAN_LOCK:
            if _ACTIVE is not None:
                raise MXNetError("a FaultPlan is already active — plans "
                                 "are process-global and do not nest")
            _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        with _PLAN_LOCK:
            _ACTIVE = None

    def fired(self, site: Optional[str] = None) -> int:
        """How many faults fired (optionally at one site)."""
        return len([e for e in self.log if site is None or e[0] == site])

    def __repr__(self):
        return (f"FaultPlan(seed={self.seed}, specs={len(self.specs)}, "
                f"fired={len(self.log)})")


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


def inject(site: str, scope: Optional[str] = None) -> None:
    """Injection-site hook.  Zero-cost when no plan is active: one global
    load and a None check — keep this the ONLY code on the disabled
    path.  ``scope`` (an engine/replica name) additionally fires the
    scoped site ``"<site>@<scope>"`` so plans can target one instance;
    the string is only built once a plan is active."""
    plan = _ACTIVE
    if plan is not None:
        plan.fire(site)
        if scope is not None:
            plan.fire(f"{site}@{scope}")


def poison(site: str) -> Optional[float]:
    """Numeric-fault query hook: ``None`` normally; NaN/Inf when an
    active plan has a due ``nonfinite_at`` spec for ``site``.  Same
    zero-cost-when-disabled contract as :func:`inject`."""
    plan = _ACTIVE
    if plan is not None:
        return plan.poison_value(site)
    return None
