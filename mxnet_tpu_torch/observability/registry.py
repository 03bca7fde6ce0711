"""Process-wide metrics registry, the one ``collect()`` surface
(counterpart of ``mxnet_tpu/observability/registry.py``).

- :class:`MetricsRegistry` holds labeled **counters**, **gauges** and
  **histograms** (histograms reuse the serving
  :class:`~mxnet_tpu_torch.serving.metrics.LatencyHistogram`: log-spaced
  buckets, 10µs…2min, so serving and training latencies share one
  shape).  All mutation and collection is lock-guarded: any number of
  writer threads may race any number of ``collect()`` readers.
- **Collectors** are pull-time callbacks for subsystems that already
  keep their own locked counters (``ServingMetrics`` registers itself
  at construction): the registry never mirrors their hot-path writes,
  it snapshots them at ``collect()``.  Collectors are held by weak
  reference where the producer supports it.
- Re-registering the same ``(name, labels)`` **replaces** the previous
  registration (last writer wins): a process that rebuilds a producer
  after a crash must not export the corpse's gauges.

``collect()`` returns a plain snapshot dict (``schema_version`` +
``samples``) that :mod:`.export` renders as Prometheus text or JSON
lines.  One process-global default registry (:func:`default_registry`)
is what every subsystem registers into; tests may build private
instances.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis.lockwitness import named_lock as _named_lock

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "default_registry"]

SCHEMA_VERSION = 1


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic counter.  ``inc`` is lock-guarded per metric so writer
    threads never contend on the registry-wide lock."""

    kind = "counter"
    __slots__ = ("name", "help", "labels", "_lock", "_value")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = _named_lock("obs.metric", "per-metric value state")
        self._value = 0

    def inc(self, n: int = 1):
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc({n}))")
        with self._lock:
            self._value += n

    @property
    def value(self):
        with self._lock:
            return self._value

    def sample(self) -> dict:
        return {"name": self.name, "kind": "counter",
                "labels": dict(self.labels), "value": self.value,
                "help": self.help}


class Gauge:
    """Point-in-time value: either ``set()`` by the producer or sampled
    through ``fn`` at collect time.  ``fn`` may hold a weakref-bound
    closure; if it raises (producer gone / mid-teardown) the sample is
    dropped from that snapshot, never the whole ``collect()``."""

    kind = "gauge"
    __slots__ = ("name", "help", "labels", "fn", "_lock", "_value")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None,
                 fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.fn = fn
        self._lock = _named_lock("obs.metric", "per-metric value state")
        self._value = 0.0

    def set(self, v: float):
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0):
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0):
        with self._lock:
            self._value -= n

    @property
    def value(self):
        if self.fn is not None:
            return float(self.fn())
        with self._lock:
            return self._value

    def sample(self) -> Optional[dict]:
        try:
            v = self.value
        except ReferenceError:
            raise                # weakref-bound producer collected:
                                 # collect() prunes this gauge for good
        except Exception:
            return None          # producer torn down mid-scrape
        return {"name": self.name, "kind": "gauge",
                "labels": dict(self.labels), "value": v,
                "help": self.help}


class Histogram:
    """Lock-guarded, log-bucketed latency histogram (one
    :class:`~mxnet_tpu_torch.serving.metrics.LatencyHistogram` per label set).
    ``sample()`` exports CUMULATIVE bucket counts — the Prometheus
    histogram contract — plus sum/count/max and the interpolated
    p50/p95/p99."""

    kind = "histogram"
    __slots__ = ("name", "help", "labels", "_lock", "_hist")

    def __init__(self, name: str, help: str = "",
                 labels: Optional[Dict[str, str]] = None):
        from ..serving.metrics import LatencyHistogram
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = _named_lock("obs.metric", "per-metric value state")
        self._hist = LatencyHistogram()

    def observe(self, seconds: float):
        with self._lock:
            self._hist.observe(seconds)

    def time(self):
        """Context manager observing the enclosed wall time."""
        return _HistTimer(self)

    def sample(self) -> dict:
        with self._lock:
            return histogram_sample(self.name, self._hist, self.labels,
                                    self.help)


class _HistTimer:
    __slots__ = ("_h", "_t0")

    def __init__(self, h: Histogram):
        self._h = h

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._h.observe(time.monotonic() - self._t0)


def histogram_sample(name: str, hist, labels: Dict[str, str],
                     help: str = "") -> dict:
    """Render one LatencyHistogram as a registry sample.  Shared with
    the ServingMetrics collector so engine-phase histograms and direct
    registry histograms export identically.  The CALLER owns whatever
    lock protects ``hist``."""
    cum, buckets = 0, []
    for i, c in enumerate(hist.counts):
        cum += c
        le = hist.bounds[i] if i < len(hist.bounds) else float("inf")
        buckets.append((le, cum))
    return {"name": name, "kind": "histogram", "labels": dict(labels),
            "help": help, "count": hist.total, "sum": hist.sum,
            "max": hist.max, "buckets": buckets,
            "p50": hist.percentile(50), "p95": hist.percentile(95),
            "p99": hist.percentile(99)}


class MetricsRegistry:
    """The lock-guarded name → metric map behind ``collect()``.

    ``counter()``/``gauge()``/``histogram()`` are get-or-create for the
    exact same (name, labels) pair — two subsystems asking for the same
    counter share it — EXCEPT that passing a new ``fn`` to ``gauge()``
    replaces the old registration (the rebuilt-engine case).
    """

    def __init__(self):
        self._lock = _named_lock("obs.registry",
                                 "metric/collector name maps")
        self._metrics: Dict[tuple, object] = {}
        self._collectors: Dict[str, Callable] = {}

    # ------------------------------------------------------------- register
    def _get_or_create(self, cls, name, help, labels, **kw):
        key = (name, _label_key(labels or {}))
        with self._lock:
            m = self._metrics.get(key)
            if m is not None and isinstance(m, cls) and not kw.get("fn"):
                return m
            m = cls(name, help=help, labels=labels, **kw) \
                if kw else cls(name, help=help, labels=labels)
            self._metrics[key] = m
            return m

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None, **labels) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels, fn=fn)

    def histogram(self, name: str, help: str = "", **labels) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels)

    def register_collector(self, name: str,
                           fn: Callable[[], List[dict]]) -> None:
        """Register a pull-time sample source: ``fn()`` returns a list
        of sample dicts (the :meth:`Counter.sample` shape).  Same name
        replaces; a raising/dead collector is skipped per-snapshot and a
        collector that raises :class:`ReferenceError` (weakref-bound
        producer collected) is pruned."""
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str) -> None:
        with self._lock:
            self._collectors.pop(name, None)

    def unregister(self, name: str, **labels) -> None:
        with self._lock:
            self._metrics.pop((name, _label_key(labels)), None)

    def reset(self) -> None:
        """Drop everything (tests)."""
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()

    # -------------------------------------------------------------- collect
    def collect(self) -> dict:
        """One atomic-enough snapshot of the whole process.

        The registry lock is held only to copy the metric/collector
        maps; each metric then samples under ITS lock, so a slow
        collector can never block writers on other metrics.  Collector
        callbacks that raise are skipped (and pruned when the producer
        was weakref-collected); a scrape must degrade, not fail.
        """
        with self._lock:
            metrics = list(self._metrics.items())
            collectors = list(self._collectors.items())
        samples: List[dict] = []
        dead_metrics = []
        for key, m in metrics:
            try:
                s = m.sample()
            except ReferenceError:
                # a weakref-bound gauge whose producer was collected:
                # prune it, same as a dead collector — scrape cost must
                # not grow with every engine a long-lived process built
                dead_metrics.append(key)
                continue
            if s is not None:
                samples.append(s)
        dead = []
        for name, fn in collectors:
            try:
                samples.extend(fn())
            except ReferenceError:
                dead.append(name)
            except Exception:
                continue
        if dead or dead_metrics:
            with self._lock:
                for name in dead:
                    self._collectors.pop(name, None)
                for key in dead_metrics:
                    self._metrics.pop(key, None)
        return {"schema_version": SCHEMA_VERSION,
                # epoch timestamp for external consumers — never used
                # for ordering, so the monotonic-clock convention does
                # not apply
                "collected_at": time.time(),
                "samples": samples}


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-global registry every subsystem registers into."""
    return _DEFAULT
