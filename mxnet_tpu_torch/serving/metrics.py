"""Serving observability (counterpart of ``mxnet_tpu/serving/metrics.py``,
the same counters, histograms and ``stats()`` layout): latency
histograms, throughput counters, and compile-cache hit tracking,
exported two ways —

- ``stats()``: a plain dict (p50/p95/p99, counts, rates) for scraping
  into whatever the host fleet uses;
- :mod:`mxnet_tpu_torch.profiler` ``Marker`` ranges around a scheduled
  batch, so a ``torch.profiler`` trace of a serving process shows
  prefill/decode batches around the kernels they launched.

The serving engine keeps its counters in one (``engine.metrics``), and
``ResilientLoop`` counts its commits, resumes, retries and bad steps
into one.

Histograms are log-spaced (10µs … ~2min) so one shape covers both a
CPU-sanity test and a GPU fleet; percentile queries interpolate inside
the winning bucket.  All mutation is lock-guarded — the scheduler thread
and any number of ``stats()`` readers may race freely.
"""
from __future__ import annotations

import math
import threading
import weakref
from typing import Dict, List, Optional

from .. import profiler as _profiler
from ..analysis.lockwitness import named_lock as _named_lock

__all__ = ["LatencyHistogram", "ServingMetrics"]

#: bump when the stats() key layout changes, so fleet scrapers can
#: version their parsing instead of guessing from key presence
STATS_SCHEMA_VERSION = 1


class LatencyHistogram:
    """Log-bucketed latency histogram over seconds.

    ``bounds[i]`` is the inclusive upper edge of bucket i; the last
    bucket is open-ended.  ``percentile`` returns a geometric
    interpolation inside the selected bucket — exact enough for
    p50/p95/p99 dashboards without keeping raw samples.
    """

    def __init__(self, lo: float = 1e-5, hi: float = 120.0,
                 buckets_per_decade: int = 5):
        n = int(math.ceil(math.log10(hi / lo) * buckets_per_decade))
        ratio = (hi / lo) ** (1.0 / n)
        self.bounds = [lo * ratio ** (i + 1) for i in range(n)]
        self.counts = [0] * (n + 1)
        self.total = 0
        self.sum = 0.0
        self.max = 0.0
        self.min = math.inf

    def observe(self, seconds: float):
        seconds = max(float(seconds), 0.0)
        lo, bounds = 0, self.bounds
        hi = len(bounds)
        while lo < hi:                       # first bound >= seconds
            mid = (lo + hi) // 2
            if bounds[mid] < seconds:
                lo = mid + 1
            else:
                hi = mid
        self.counts[lo] += 1
        self.total += 1
        self.sum += seconds
        self.max = max(self.max, seconds)
        self.min = min(self.min, seconds)

    def percentile(self, q: float) -> float:
        """q in [0, 100]; 0 with no samples.

        A percentile is an order statistic: the result must lie inside
        ``[self.min, self.max]`` — the observed extremes — no matter
        which bucket wins.  Interpolation alone violates BOTH ends: a
        bucket's upper edge can overshoot the true sample max (and the
        open-ended top bucket has no finite edge at all), and the
        winning bucket's lower edge can undershoot the true sample min
        (every sample in bucket 0 sits below the synthetic
        ``bounds[0]/2`` floor whenever the real samples are tiny).  So
        every return path clamps to the observed extremes.
        """
        if not self.total:
            return 0.0
        rank = q / 100.0 * self.total
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                if i >= len(self.bounds):            # open-ended tail
                    return self.max
                lo = self.bounds[i - 1] if i else self.bounds[0] / 2
                hi = self.bounds[i]
                frac = (rank - (seen - c)) / c
                val = lo * (hi / lo) ** frac         # geometric interp
                return min(max(val, self.min), self.max)
        return self.max

    def summary(self) -> Dict[str, float]:
        mean = self.sum / self.total if self.total else 0.0
        return {"count": self.total,
                "mean_ms": round(mean * 1e3, 3),
                "p50_ms": round(self.percentile(50) * 1e3, 3),
                "p95_ms": round(self.percentile(95) * 1e3, 3),
                "p99_ms": round(self.percentile(99) * 1e3, 3),
                "max_ms": round(self.max * 1e3, 3)}


class ServingMetrics:
    """All engine counters + the per-request PHASE latency histograms:
    queue (submit→scheduled), prefill (scheduled→first token, including
    any prefix-cache copy and every chunk), decode (first token→done),
    total, and TTFT (submit→first token — the latency users feel and the
    number the prefix cache exists to cut)."""

    _COUNTERS = ("submitted", "admitted", "completed", "rejected_queue_full",
                 "rejected_invalid", "timeouts", "cancelled",
                 "prefill_batches", "prefill_chunks", "decode_steps",
                 "forward_batches",
                 "bucket_hits", "compiles", "tokens_generated",
                 "prompt_tokens", "padded_tokens",
                 # prefix cache (docs/serving.md): admission hits/misses,
                 # prompt tokens whose prefill was skipped via a cached
                 # prefix, LRU evictions under pool pressure, entries
                 # inserted, and host/copy faults contained at the
                 # serving.prefix_* injection sites
                 "prefix_hits", "prefix_misses", "prefix_tokens_saved",
                 "prefix_evictions", "prefix_inserts", "prefix_faults",
                 # resilience: transient-step retries, watchdog
                 # condemnations, atomic checkpoint commits, resumes;
                 # state integrity (docs/integrity.md): corrupt steps
                 # quarantined during verified restore and restores
                 # that fell back to an older intact step
                 "retries", "watchdog_trips", "checkpoint_commits",
                 "resumes", "checkpoint_quarantines",
                 "checkpoint_fallbacks",
                 # training-health guardrails (docs/guardrails.md):
                 # skipped non-finite training steps, checkpoint
                 # rewinds, quarantined input batches, and per-request
                 # non-finite serving outputs
                 "bad_steps", "rewinds", "quarantined_batches",
                 "nonfinite_outputs",
                 # overload control (docs/overload.md): rejections by
                 # the deadline-feasibility admission gate, rejections
                 # of requests arriving at a crashed engine, slot
                 # preemptions (+ their resumes), brownout entries, and
                 # contained faults at the overload.* injection sites
                 "rejected_infeasible", "rejected_crashed",
                 "preemptions", "preempt_resumes", "brownouts",
                 "overload_faults", "prefix_inserts_paused",
                 # estimator denominator: tokens whose decode time IS
                 # in the decode histogram (completed runs only —
                 # preempted segments count toward tokens_generated
                 # throughput but their wall time never reaches the
                 # histogram, so they must not dilute per-token cost)
                 "decode_tokens_observed",
                 # speculative decode (docs/serving.md "Speculative
                 # decode"): draft+verify cycles run, draft tokens
                 # proposed vs accepted (their ratio is the acceptance
                 # rate the drafter is judged by), contained faults at
                 # the serving.draft / serving.verify sites (each
                 # degrades that cycle to plain one-token decode), and
                 # pages released by the paged-KV rewind of rejected
                 # speculation
                 "spec_cycles", "spec_tokens_proposed",
                 "spec_tokens_accepted", "spec_faults",
                 "spec_pages_rewound",
                 # paged KV layout (docs/serving.md "Paged KV"):
                 # page-pool exhaustion / contained page_alloc-fault
                 # events (each degrades to an alloc retry or a
                 # park-by-reference, never a failed request) and pages
                 # zeroed by scrub-on-NaN when their last reader freed
                 # them
                 "page_faults", "pages_scrubbed",
                 # disaggregated serving (docs/serving.md
                 # "Disaggregated serving"): completed prefill→decode
                 # handoffs by direction, KV pages moved, and contained
                 # faults at the serving.migrate_* sites (each degrades
                 # to colocated fallback — the prefill engine finishes
                 # the request itself, nothing is lost)
                 "migrations_out", "migrations_in", "migrated_pages",
                 "migrate_faults",
                 # tiered prefix cache (docs/serving.md "Tiered prefix
                 # cache"): bundles demoted device→host / promoted
                 # host→device, radix hits against tier-2 claims,
                 # promotion misses (stale claim, verify failure, fault,
                 # timeout — each degrades to recompute), seals that
                 # failed verify-on-promote (rot caught BEFORE any
                 # device byte moved), host-pool LRU evictions,
                 # contained serving.tier_* faults, demotions dropped
                 # (queue full / oversized / non-finite), and the
                 # optional disk tier's spills / loads / quarantines
                 "tier_demotes", "tier_promotes", "tier_hits",
                 "tier_misses", "tier_verify_failures", "tier_evictions",
                 "tier_faults", "tier_drops", "tier_disk_spills",
                 "tier_disk_loads", "tier_quarantines",
                 # quantized KV pages (docs/serving.md "Quantized KV +
                 # paged attention kernel"): pages claimed for int8
                 # storage, contained serving.kv_quant quantize-write
                 # faults (each degrades to a counted recompute next
                 # cycle), and poisoned-scale detections at dequant
                 # (the page is tainted via the dirty-page scrub path,
                 # never served)
                 "kv_quant_pages", "kv_quant_faults",
                 "kv_dequant_faults")

    def __init__(self, name: str = "serving", register: bool = True):
        self.name = name
        self._lock = _named_lock("serving.metrics",
                                 "per-engine counter/histogram state")
        self.counters = {k: 0 for k in self._COUNTERS}
        # overload observability (docs/overload.md): sheds keyed by
        # (reason, priority class) and completions keyed by class —
        # the per-class accounting graceful degradation is judged by
        self.sheds_by = {}           # (reason, priority) -> count
        self.served_by = {}          # priority -> count
        # disaggregated serving: handoffs keyed by (direction,
        # outcome) — 'out'/'in' x 'ok'/'fallback' — plus the
        # export→accept latency histogram (host copy + digest +
        # adopt-side install)
        self.migrations_by = {}      # (direction, outcome) -> count
        self.migration = LatencyHistogram()
        # quantized KV divergence: max-abs logit delta of each sampled
        # step vs the fp32 reference arm (debug_parity= on).  The
        # bounds cover float32-epsilon noise up to an outright-broken
        # 1e3 delta — the divergence CONTRACT is asserted by tests/
        # bench against this histogram's max.
        self.kv_quant_error = LatencyHistogram(lo=1e-9, hi=1e3,
                                               buckets_per_decade=2)
        self.queue = LatencyHistogram()
        self.prefill = LatencyHistogram()
        self.decode = LatencyHistogram()
        self.total = LatencyHistogram()
        self.ttft = LatencyHistogram()
        if register:
            self._register_collector()

    def _register_collector(self):
        """Publish this instance into the process-wide observability
        registry (docs/observability.md): one ``collect()`` then covers
        these counters/histograms under stable ``mxtpu_serving_*``
        names with an ``engine=<name>`` label.  Held by WEAKREF — a
        garbage-collected engine's metrics prune themselves from the
        next scrape; a new instance under the same name replaces the
        old registration (the rebuilt-engine case)."""
        from ..observability.registry import default_registry
        ref = weakref.ref(self)

        def _samples():
            m = ref()
            if m is None:
                raise ReferenceError("ServingMetrics collected")
            return m.registry_samples()

        default_registry().register_collector(f"serving:{self.name}",
                                              _samples)

    def registry_samples(self) -> List[dict]:
        """Stable-name samples for :meth:`MetricsRegistry.collect`:
        every counter as ``mxtpu_serving_<counter>_total{engine=}`` and
        the five phase histograms as
        ``mxtpu_serving_latency_seconds{engine=,phase=}`` /
        ``mxtpu_serving_ttft_seconds{engine=}``.  One lock acquisition
        — the scrape sees a consistent cut, same contract as
        :meth:`stats`."""
        from ..observability.registry import histogram_sample
        eng = {"engine": self.name}
        with self._lock:
            samples = [
                {"name": f"mxtpu_serving_{k}_total", "kind": "counter",
                 "labels": dict(eng), "value": v, "help": ""}
                for k, v in self.counters.items()]
            samples.extend(
                {"name": "mxtpu_serving_sheds_total", "kind": "counter",
                 "labels": {"engine": self.name, "reason": reason,
                            "priority": prio},
                 "value": v, "help": ""}
                for (reason, prio), v in sorted(self.sheds_by.items()))
            samples.extend(
                {"name": "mxtpu_serving_served_total", "kind": "counter",
                 "labels": {"engine": self.name, "priority": prio},
                 "value": v, "help": ""}
                for prio, v in sorted(self.served_by.items()))
            samples.extend(
                {"name": "mxtpu_serving_migrations_total",
                 "kind": "counter",
                 "labels": {"engine": self.name, "direction": d,
                            "outcome": outcome},
                 "value": v, "help": ""}
                for (d, outcome), v in sorted(self.migrations_by.items()))
            samples.append(histogram_sample(
                "mxtpu_serving_migration_latency_seconds",
                self.migration, eng))
            for phase, h in (("queue", self.queue),
                             ("prefill", self.prefill),
                             ("decode", self.decode),
                             ("total", self.total)):
                samples.append(histogram_sample(
                    "mxtpu_serving_latency_seconds", h,
                    {"engine": self.name, "phase": phase}))
            samples.append(histogram_sample(
                "mxtpu_serving_ttft_seconds", self.ttft, eng))
            samples.append(histogram_sample(
                "mxtpu_serving_kv_quant_error", self.kv_quant_error,
                eng))
        return samples

    # ------------------------------------------------------------- counters
    def count(self, key: str, n: int = 1):
        with self._lock:
            self.counters[key] = self.counters.get(key, 0) + n

    def count_shed(self, reason: str, priority: str, n: int = 1):
        """One shed, labeled by reason (``queue_full`` /
        ``deadline_infeasible`` / ``priority_shed`` / ``brownout``) and
        the victim's priority class."""
        with self._lock:
            k = (reason, priority)
            self.sheds_by[k] = self.sheds_by.get(k, 0) + n

    def count_served(self, priority: str, n: int = 1):
        with self._lock:
            self.served_by[priority] = self.served_by.get(priority, 0) + n

    def count_migration(self, direction: str, outcome: str, n: int = 1):
        """One disaggregated handoff attempt, labeled by direction
        (``out`` on the prefill engine, ``in`` on the decode engine)
        and outcome (``ok`` / ``fallback``)."""
        with self._lock:
            k = (direction, outcome)
            self.migrations_by[k] = self.migrations_by.get(k, 0) + n

    def observe_migration(self, seconds: float):
        """Latency of one accepted handoff, export through adopt."""
        with self._lock:
            self.migration.observe(seconds)

    def observe_quant_error(self, delta: float):
        """Max-abs logit delta of one sampled step vs the fp32
        reference arm (``debug_parity=`` on)."""
        with self._lock:
            self.kv_quant_error.observe(delta)

    # ---------------------------------------------------------- estimators
    def latency_estimates(self, min_count: int = 8):
        """Admission-time latency estimators for the deadline-
        feasibility gate (docs/overload.md), or ``None`` until the
        phase histograms hold at least ``min_count`` completions:
        ``(prefill_p50_s, decode_s_per_token, service_p50_s)`` where
        ``service_p50`` is one request's scheduled-to-done median (the
        per-wave queue-drain estimate)."""
        with self._lock:
            if (self.prefill.total < min_count
                    or self.decode.total < min_count):
                return None
            toks = self.counters["decode_tokens_observed"]
            if toks <= 0:
                return None
            prefill_p50 = self.prefill.percentile(50)
            per_token = self.decode.sum / toks
            service_p50 = prefill_p50 + self.decode.percentile(50)
            return prefill_p50, per_token, service_p50

    def observe_request(self, queue_s: float, prefill_s: float,
                        decode_s: Optional[float] = None):
        """Record one completed request.  ``decode_s=None`` means the
        request HAD no decode phase (forward mode): the decode and TTFT
        histograms are skipped entirely — token-phase percentiles over a
        tokenless mode would just be rows of zeros on a dashboard.  A
        real 0.0 (a decode request finishing on its first token) is
        counted."""
        with self._lock:
            self.queue.observe(queue_s)
            self.prefill.observe(prefill_s)
            self.total.observe(queue_s + prefill_s + (decode_s or 0.0))
            if decode_s is not None:
                self.decode.observe(decode_s)
                self.ttft.observe(queue_s + prefill_s)

    # ------------------------------------------------- profiler integration
    def span(self, kind: str):
        """Named range in the device trace around one scheduled batch
        (shows up next to the kernels it launched)."""
        return _profiler.Marker(f"{self.name}:{kind}").span()

    def mark(self, event: str, value=None):
        """Instant marker (e.g. admission, shed, timeout); ``value``
        (batch size, queue depth, …) is embedded in the annotation."""
        _profiler.Marker(f"{self.name}:{event}").mark(value=value)

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        # ONE lock acquisition end to end: scrapers must never see a
        # torn snapshot where e.g. the latency counts moved between the
        # requests sub-dict and the ttft sub-dict (the derived dicts
        # below only reshape the locked copies, so atomicity holds)
        with self._lock:
            c = dict(self.counters)
            sheds_by = dict(self.sheds_by)
            served_by = dict(self.served_by)
            migrations_by = dict(self.migrations_by)
            migration_lat = self.migration.summary()
            quant_err = {"count": self.kv_quant_error.total,
                         "max": self.kv_quant_error.max,
                         "p99": self.kv_quant_error.percentile(99)}
            lat = {"queue": self.queue.summary(),
                   "prefill": self.prefill.summary(),
                   "decode": self.decode.summary(),
                   "total": self.total.summary()}
            ttft = self.ttft.summary()
        sheds_nested: dict = {}
        for (reason, prio), v in sorted(sheds_by.items()):
            sheds_nested.setdefault(reason, {})[prio] = v
        lookups = c["bucket_hits"] + c["compiles"]
        pref = c["prefix_hits"] + c["prefix_misses"]
        return {
            "schema_version": STATS_SCHEMA_VERSION,
            "requests": {k: c[k] for k in
                         ("submitted", "admitted", "completed",
                          "rejected_queue_full", "rejected_invalid",
                          "timeouts", "cancelled")},
            "batches": {k: c[k] for k in
                        ("prefill_batches", "prefill_chunks",
                         "decode_steps", "forward_batches")},
            "tokens": {k: c[k] for k in
                       ("tokens_generated", "prompt_tokens",
                        "padded_tokens")},
            "compile_cache": {
                "bucket_hits": c["bucket_hits"],
                "compiles": c["compiles"],
                "hit_rate": round(c["bucket_hits"] / lookups, 4)
                if lookups else None,
            },
            "prefix_cache": {
                "prefix_hits": c["prefix_hits"],
                "prefix_misses": c["prefix_misses"],
                "prefix_tokens_saved": c["prefix_tokens_saved"],
                "prefix_evictions": c["prefix_evictions"],
                "prefix_inserts": c["prefix_inserts"],
                "prefix_faults": c["prefix_faults"],
                "hit_rate": round(c["prefix_hits"] / pref, 4)
                if pref else None,
            },
            "ttft": ttft,
            # speculative decode (docs/serving.md): acceptance_rate is
            # accepted / proposed DRAFT tokens (the bonus token every
            # cycle banks is not "proposed", so a dead drafter reads
            # 0.0, not 1/k)
            "speculative": {
                "spec_cycles": c["spec_cycles"],
                "spec_tokens_proposed": c["spec_tokens_proposed"],
                "spec_tokens_accepted": c["spec_tokens_accepted"],
                "spec_faults": c["spec_faults"],
                "spec_pages_rewound": c["spec_pages_rewound"],
                "acceptance_rate": round(
                    c["spec_tokens_accepted"] / c["spec_tokens_proposed"],
                    4) if c["spec_tokens_proposed"] else None,
            },
            # disaggregated serving (docs/serving.md): handoff counts
            # by (direction, outcome) plus the export→adopt latency
            "migration": {
                "migrations_out": c["migrations_out"],
                "migrations_in": c["migrations_in"],
                "migrated_pages": c["migrated_pages"],
                "migrate_faults": c["migrate_faults"],
                "by": {f"{d}/{outcome}": v for (d, outcome), v
                       in sorted(migrations_by.items())},
                "latency": migration_lat,
            },
            # tiered prefix cache (docs/serving.md "Tiered prefix
            # cache"); the engine overlays its live store snapshot
            # under stats()["tier"]["store"]
            "tier": {k: c[k] for k in
                     ("tier_demotes", "tier_promotes", "tier_hits",
                      "tier_misses", "tier_verify_failures",
                      "tier_evictions", "tier_faults", "tier_drops",
                      "tier_disk_spills", "tier_disk_loads",
                      "tier_quarantines")},
            # per-class accounting of graceful degradation
            # (docs/overload.md); the engine overlays its controller
            # snapshot under stats()["overload"]["controller"]
            "overload": {
                "sheds": sheds_nested,
                "served": served_by,
                "rejected_infeasible": c["rejected_infeasible"],
                "rejected_crashed": c["rejected_crashed"],
                "preemptions": c["preemptions"],
                "preempt_resumes": c["preempt_resumes"],
                "brownouts": c["brownouts"],
                "overload_faults": c["overload_faults"],
            },
            # quantized KV pages (docs/serving.md "Quantized KV +
            # paged attention kernel"); error is the debug_parity
            # divergence histogram (raw logit units, NOT seconds)
            "quantized_kv": {
                "kv_quant_pages": c["kv_quant_pages"],
                "kv_quant_faults": c["kv_quant_faults"],
                "kv_dequant_faults": c["kv_dequant_faults"],
                "error": quant_err,
            },
            "resilience": {k: c[k] for k in
                           ("retries", "watchdog_trips",
                            "checkpoint_commits", "resumes",
                            "checkpoint_quarantines",
                            "checkpoint_fallbacks",
                            "bad_steps", "rewinds",
                            "quarantined_batches",
                            "nonfinite_outputs")},
            "latency": lat,
        }
