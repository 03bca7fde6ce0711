"""Service-level objectives over the metrics the engine already keeps.

(Counterpart of ``mxnet_tpu/observability/slo.py``.)  The registry gives
the process one scrape surface; this module turns it into a
*verdict*: are we inside our latency/availability objectives, how fast
are we burning the error budget, and how much is left.  Nothing here
adds hot-path instrumentation — an :class:`SLOTracker` evaluates AT
SCRAPE TIME from the phase/TTFT histograms and shed/served counters a
:class:`~mxnet_tpu_torch.serving.metrics.ServingMetrics` instance already
maintains, and exports the verdict as ``mxtpu_slo_*`` gauges in the
lint-enforced catalog (docs/observability.md).

Objectives (declare any subset; at least one):

- ``ttft_p99`` — seconds: the TTFT histogram's p99 must sit at or
  under the target; the implied good-fraction target is 99%, so the
  error budget is the worst 1% and the burn rate is
  ``fraction_above(target) / 0.01``.
- ``deadline_hit_rate`` — fraction: served requests that met their
  deadline, ``completed / (completed + timeouts)``.
- ``availability`` — fraction: requests the server answered vs denied
  through its own fault, ``completed / (completed + queue-full sheds +
  crashed-engine rejections)``.  Client-fault rejections (invalid
  requests, infeasible deadlines) are excluded — an SLO measures the
  *server's* promise.

**Burn rate** is the instantaneous spend: the error fraction over the
delta since the previous evaluation, divided by the budget (1.0 =
burning exactly at budget; 10x means the budget dies in a tenth of the
period).  **Budget remaining** integrates since the tracker's baseline
(construction or :meth:`~SLOTracker.reset`): ``1 - errors /
(budget * total)``, negative once the objective is blown.

A breach transition (ok → breached) is a flight-recorder trigger
(``slo.breach``, :mod:`.flightrecorder`) — latched per objective, so a
breached SLO produces one bundle at the edge, not one per scrape.
"""
from __future__ import annotations

import math
import weakref
from typing import Dict, List, Optional

from ..analysis.lockwitness import named_lock as _named_lock
from ..base import MXNetError

__all__ = ["SLO", "SLOTracker", "fraction_above", "tracker_snapshots"]

#: objective key -> kind ("latency" targets are upper bounds in
#: seconds; "fraction" targets are lower bounds in [0, 1])
OBJECTIVES = {"ttft_p99": "latency",
              "deadline_hit_rate": "fraction",
              "availability": "fraction"}

#: the good-fraction a pNN latency objective implies (p99 -> 0.99)
_TTFT_GOOD_FRACTION = 0.99


class SLO:
    """A declared set of objectives (the targets, not the tracker)."""

    __slots__ = ("name", "ttft_p99", "deadline_hit_rate", "availability")

    def __init__(self, name: str = "serving",
                 ttft_p99: Optional[float] = None,
                 deadline_hit_rate: Optional[float] = None,
                 availability: Optional[float] = None):
        if ttft_p99 is None and deadline_hit_rate is None \
                and availability is None:
            raise MXNetError(
                "SLO needs at least one objective: ttft_p99= (seconds), "
                "deadline_hit_rate= and/or availability= (fractions)")
        if ttft_p99 is not None and not ttft_p99 > 0:
            raise MXNetError(f"ttft_p99 must be > 0 seconds, "
                             f"got {ttft_p99}")
        for k, v in (("deadline_hit_rate", deadline_hit_rate),
                     ("availability", availability)):
            if v is not None and not (0.0 < float(v) < 1.0):
                raise MXNetError(f"{k} must be a fraction in (0, 1), "
                                 f"got {v} — 1.0 leaves a zero error "
                                 "budget (no burn rate is finite)")
        self.name = str(name)
        self.ttft_p99 = None if ttft_p99 is None else float(ttft_p99)
        self.deadline_hit_rate = None if deadline_hit_rate is None \
            else float(deadline_hit_rate)
        self.availability = None if availability is None \
            else float(availability)

    def targets(self) -> Dict[str, float]:
        return {k: getattr(self, k) for k in OBJECTIVES
                if getattr(self, k) is not None}

    def __repr__(self):
        t = ", ".join(f"{k}={v:g}" for k, v in self.targets().items())
        return f"SLO({self.name!r}, {t})"


def fraction_above(hist, threshold: float) -> float:
    """Fraction of a :class:`LatencyHistogram`'s samples above
    ``threshold`` seconds, geometric-interpolating inside the
    straddling bucket — the latency-SLO error fraction.  The caller
    owns whatever lock guards ``hist`` (the
    :func:`~mxnet_tpu_torch.observability.registry.histogram_sample`
    convention)."""
    if not hist.total:
        return 0.0
    if threshold >= hist.max:
        return 0.0
    above = 0.0
    for i, c in enumerate(hist.counts):
        if not c:
            continue
        lo = hist.bounds[i - 1] if i else hist.bounds[0] / 2
        hi = hist.bounds[i] if i < len(hist.bounds) else hist.max
        if lo >= threshold:
            above += c
        elif hi > threshold and hi > lo:
            # geometric split, matching percentile()'s interpolation
            frac_below = math.log(threshold / lo) / math.log(hi / lo)
            above += c * (1.0 - min(max(frac_below, 0.0), 1.0))
    return min(above / hist.total, 1.0)


class _HistDelta:
    """A windowed cut of a cumulative LatencyHistogram: the difference
    of two bucket-count SNAPSHOTS (both captured inside :meth:`_cut`'s
    single lock acquisition — re-reading the live histogram here would
    double-count samples that landed between the cut and the read),
    with percentile/fraction queries over just that window."""

    __slots__ = ("counts", "bounds", "total", "max", "min")

    def __init__(self, bounds: List[float], base_counts: List[int],
                 now_counts: List[int], hist_max: float,
                 hist_min: float):
        self.counts = [c - b for c, b in zip(now_counts, base_counts)]
        self.bounds = bounds
        self.total = sum(self.counts)
        # window extremes are unknowable from a cumulative histogram;
        # the observed-lifetime extremes are the only honest clamp
        self.max = hist_max
        self.min = hist_min

    def percentile(self, q: float) -> float:
        from ..serving.metrics import LatencyHistogram
        h = LatencyHistogram.__new__(LatencyHistogram)
        h.bounds, h.counts, h.total = self.bounds, self.counts, self.total
        h.sum, h.max, h.min = 0.0, self.max, self.min
        return h.percentile(q)


class SLOTracker:
    """Evaluate an :class:`SLO` against one metrics source at scrape
    time.

    ``source`` is a :class:`~mxnet_tpu_torch.serving.metrics.ServingMetrics`
    or anything carrying one as ``.metrics`` (an
    :class:`~mxnet_tpu_torch.serving.InferenceEngine`, a
    :class:`~mxnet_tpu_torch.resilience.ResilientLoop`).  ``register=True``
    (default) publishes a pull-time collector into the process
    registry: every ``collect()`` re-evaluates and exports the
    ``mxtpu_slo_*`` gauge family, so the SLO verdict rides the same
    scrape as the metrics it judges — and a breach detected there
    fires the flight recorder.
    """

    def __init__(self, slo: SLO, source, *, register: bool = True):
        m = getattr(source, "metrics", source)
        from ..serving.metrics import ServingMetrics
        if not isinstance(m, ServingMetrics):
            raise MXNetError(
                "SLOTracker needs a ServingMetrics (or an object with "
                f".metrics), got {type(source).__name__} — the SLO is "
                "evaluated from its phase/TTFT histograms and counters")
        self.slo = slo
        self.metrics = m
        self._lock = _named_lock("obs.slo",
                                 "SLO baseline/window/breach state")
        self._breached: Dict[str, bool] = {k: False for k in slo.targets()}
        base = self._cut()
        self._baseline = base
        self._last = base
        self._records: List[dict] = []
        _TRACKERS.add(self)
        if register:
            self._register_collector()

    # ---------------------------------------------------------------- cuts
    def _cut(self) -> dict:
        """One consistent snapshot of the source counters + the TTFT
        bucket vector (the metrics' own lock makes it torn-free)."""
        m = self.metrics
        with m._lock:
            c = m.counters
            return {
                "completed": c.get("completed", 0),
                "timeouts": c.get("timeouts", 0),
                "rejected_queue_full": c.get("rejected_queue_full", 0),
                "rejected_crashed": c.get("rejected_crashed", 0),
                "ttft_counts": list(m.ttft.counts),
                "ttft_max": m.ttft.max,
                "ttft_min": m.ttft.min,
            }

    # ------------------------------------------------------------ evaluation
    def evaluate(self) -> List[dict]:
        """Score every declared objective; returns one record per
        objective (also cached for bundle snapshots).  Breach
        transitions fire the flight recorder AFTER the tracker lock is
        released — the bundle's registry collect() re-enters this
        collector, which must find the evaluation finished, not the
        lock held."""
        now_cut = self._cut()
        newly_breached = []
        with self._lock:
            base, last = self._baseline, self._last
            self._last = now_cut
            records = []
            for objective, target in self.slo.targets().items():
                rec = self._score(objective, target, base, last, now_cut)
                was = self._breached[objective]
                self._breached[objective] = rec["breached"]
                if rec["breached"] and not was:
                    newly_breached.append(rec)
                records.append(rec)
            self._records = records
        for rec in newly_breached:
            from . import flightrecorder as _fr
            fr = _fr.active()
            if fr is not None:
                fr.trigger("slo.breach", slo=self.slo.name,
                           objective=rec["objective"],
                           observed=rec["observed"],
                           target=rec["target"],
                           burn_rate=rec["burn_rate"])
        return records

    def _score(self, objective: str, target: float, base: dict,
               last: dict, now: dict) -> dict:
        if objective == "ttft_p99":
            # all three cuts come from _cut() snapshots: the window is
            # base→now and the burn window last→now, over the SAME
            # `now` vector — re-reading the live histogram here would
            # count samples landing mid-evaluation twice (once in this
            # burn rate, once in the next window's)
            bounds = self.metrics.ttft.bounds
            window = _HistDelta(bounds, base["ttft_counts"],
                                now["ttft_counts"], now["ttft_max"],
                                now["ttft_min"])
            recent = _HistDelta(bounds, last["ttft_counts"],
                                now["ttft_counts"], now["ttft_max"],
                                now["ttft_min"])
            observed = window.percentile(99)
            breached = window.total > 0 and observed > target
            budget = 1.0 - _TTFT_GOOD_FRACTION
            err_window = fraction_above(window, target)
            err_recent = fraction_above(recent, target)
            total = window.total
        else:
            if objective == "deadline_hit_rate":
                good_k, bad_ks = "completed", ("timeouts",)
            else:                     # availability
                good_k, bad_ks = "completed", ("rejected_queue_full",
                                               "rejected_crashed")

            def frac(cut_a, cut_b):
                good = cut_b[good_k] - cut_a[good_k]
                bad = sum(cut_b[k] - cut_a[k] for k in bad_ks)
                n = good + bad
                return (good / n if n else 1.0), n

            observed, total = frac(base, now)
            recent_rate, recent_n = frac(last, now)
            breached = total > 0 and observed < target
            budget = 1.0 - target
            err_window = 1.0 - observed
            err_recent = 1.0 - recent_rate if recent_n else 0.0
        burn = err_recent / budget if budget else float("inf")
        remaining = 1.0 - (err_window / budget if budget
                           else float("inf"))
        return {"slo": self.slo.name, "objective": objective,
                "kind": OBJECTIVES[objective], "target": target,
                "observed": observed, "samples": total,
                "breached": bool(breached),
                "burn_rate": burn, "budget_remaining": remaining}

    def reset(self) -> None:
        """Re-baseline: the error budget starts fresh (a new SLO
        period) and breach latches clear."""
        cut = self._cut()
        with self._lock:
            self._baseline = cut
            self._last = cut
            for k in self._breached:
                self._breached[k] = False
            self._records = []

    def snapshot(self) -> dict:
        """The last evaluation without re-evaluating — what flight
        bundles embed (a bundle triggered FROM a breach must not
        re-enter evaluate())."""
        with self._lock:
            records = list(self._records)
        return {"slo": self.slo.name, "source": self.metrics.name,
                "targets": self.slo.targets(), "objectives": records}

    # ------------------------------------------------------------- registry
    def _register_collector(self):
        from .registry import default_registry
        ref = weakref.ref(self)

        def _samples():
            t = ref()
            if t is None:
                raise ReferenceError("SLOTracker collected")
            return t.registry_samples()

        # keyed by (slo name, metrics source): same-name registration
        # replaces, and a fleet declares ONE SLO name across N replica
        # trackers — without the source in the key each registration
        # would silently evict the previous replica's gauges
        default_registry().register_collector(
            f"slo:{self.slo.name}:{self.metrics.name}", _samples)

    def registry_samples(self) -> List[dict]:
        """Evaluate and render the gauge family (one sample set per
        objective) — the scrape-time entry point."""
        samples = []
        for rec in self.evaluate():
            # `source` disambiguates trackers sharing one SLO name
            # (one per fleet replica): without it their sample label
            # sets would collide in a single scrape
            lbl = {"slo": rec["slo"], "objective": rec["objective"],
                   "source": self.metrics.name}
            for name, value, help in (
                    ("mxtpu_slo_target", rec["target"],
                     "declared objective target (seconds for latency "
                     "objectives, fraction otherwise)"),
                    ("mxtpu_slo_value", rec["observed"],
                     "observed value since the tracker baseline"),
                    ("mxtpu_slo_breached", 1.0 if rec["breached"] else 0.0,
                     "1 while the objective is out of target"),
                    ("mxtpu_slo_burn_rate", rec["burn_rate"],
                     "error-budget spend rate since the previous "
                     "evaluation (1.0 = exactly at budget)"),
                    ("mxtpu_slo_budget_remaining", rec["budget_remaining"],
                     "error budget left since the tracker baseline "
                     "(negative = objective blown)")):
                samples.append({"name": name, "kind": "gauge",
                                "labels": dict(lbl), "value": value,
                                "help": help})
        return samples

    def __repr__(self):
        return f"SLOTracker({self.slo!r})"


#: live trackers, weakly held — what flight bundles enumerate
_TRACKERS: "weakref.WeakSet[SLOTracker]" = weakref.WeakSet()


def tracker_snapshots() -> List[dict]:
    """Last-evaluation snapshots of every live tracker (no
    re-evaluation — safe from inside a flight-bundle dump)."""
    return [t.snapshot() for t in list(_TRACKERS)]
