"""Low-overhead span tracing with cross-thread propagation (counterpart
of ``mxnet_tpu/observability/trace.py``).

A **span** is a named ``[t0, t1)`` interval tagged with a ``trace_id``;
every span of one serving request (or one training run) shares the id,
so a bounded ring buffer of spans can be re-assembled into a per-trace
timeline: ``loop.step → trainer.step → checkpoint.commit`` for
training.

Design rules (the contract of :mod:`mxnet_tpu_torch.resilience.faults`):

- **zero-cost when disabled**: every instrumentation site does ONE
  module-global load plus a ``None`` check and nothing else.
- **propagation crosses threads by value**: a caller stamps
  ``trace_id`` on its request; the thread that serves it reads it, with
  no thread-locals to lose across a queue.  One device call serving many
  requests records ONE span carrying ``trace_ids`` of every rider.
- **bounded memory**: spans land in a ``deque(maxlen=capacity)`` ring.
- **device-trace bridge**: with ``profiler_markers=True`` each span
  also opens a :func:`mxnet_tpu_torch.profiler.device_span` range
  (``torch.profiler.record_function``), so the same span names land in
  a ``torch.profiler`` trace around the CUDA kernels they cover, where
  the reference's land in a ``jax.profiler`` trace.  A span's times are
  the host's: around a graph replay they measure the enqueue, as the
  reference's spans around an asynchronous dispatch do.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..analysis.lockwitness import named_lock as _named_lock

__all__ = ["Span", "Tracer", "enable", "disable", "active"]


class Span:
    """One recorded interval (or instant, when ``t1 == t0``)."""

    __slots__ = ("name", "trace_id", "trace_ids", "t0", "t1", "attrs")

    def __init__(self, name: str, trace_id: Optional[int], t0: float,
                 t1: float, trace_ids: Optional[tuple] = None,
                 attrs: Optional[dict] = None):
        self.name = name
        self.trace_id = trace_id
        self.trace_ids = trace_ids or ()
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs or {}

    def in_trace(self, trace_id: int) -> bool:
        return self.trace_id == trace_id or trace_id in self.trace_ids

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def as_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "trace_ids": list(self.trace_ids), "t0": self.t0,
                "t1": self.t1,
                "duration_ms": round(1e3 * (self.t1 - self.t0), 4),
                "attrs": dict(self.attrs)}

    def __repr__(self):
        tid = self.trace_id if self.trace_id is not None else \
            list(self.trace_ids)
        return (f"Span({self.name!r}, trace={tid}, "
                f"{1e3 * (self.t1 - self.t0):.3f}ms)")


class _LiveSpan:
    """A started-but-unfinished span; also usable as a context manager.
    Recording happens at ``finish()`` so a span abandoned by a crashed
    step simply never lands in the ring (no torn half-spans)."""

    __slots__ = ("_tracer", "name", "trace_id", "trace_ids", "t0",
                 "attrs", "_marker")

    def __init__(self, tracer: "Tracer", name: str,
                 trace_id: Optional[int], trace_ids: Optional[tuple],
                 attrs: dict):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.trace_ids = trace_ids
        self.attrs = attrs
        self._marker = None
        if tracer.profiler_markers:
            from .. import profiler as _profiler
            self._marker = _profiler.device_span(name)
            self._marker.start()
        self.t0 = time.monotonic()

    def finish(self, **attrs):
        t1 = time.monotonic()
        if self._marker is not None:
            self._marker.stop()
            self._marker = None
        if attrs:
            self.attrs.update(attrs)
        self._tracer._record(Span(self.name, self.trace_id, self.t0, t1,
                                  self.trace_ids, self.attrs))

    def __enter__(self):
        return self

    def __exit__(self, etype, exc, tb):
        if etype is not None:
            self.attrs["error"] = etype.__name__
        self.finish()


class Tracer:
    """Ring-buffered span recorder.  Thread-safe throughout."""

    def __init__(self, capacity: int = 4096,
                 profiler_markers: bool = False):
        self.capacity = int(capacity)
        self.profiler_markers = bool(profiler_markers)
        self._lock = _named_lock("obs.trace_ring",
                                 "tracer span ring buffer")
        self._ring: deque = deque(maxlen=self.capacity)
        self._ids = itertools.count(1)
        self.dropped = 0          # spans evicted by the ring bound

    # ---------------------------------------------------------------- ids
    def new_trace_id(self) -> int:
        """A fresh process-unique trace id (itertools.count is GIL-atomic)."""
        return next(self._ids)

    # ------------------------------------------------------------- recording
    def _record(self, span: Span):
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(span)

    def span(self, name: str, trace_id: Optional[int] = None,
             trace_ids: Optional[tuple] = None, **attrs) -> _LiveSpan:
        """Start a span; finish via ``with`` or ``.finish()``."""
        return _LiveSpan(self, name, trace_id,
                         tuple(trace_ids) if trace_ids else None, attrs)

    def record_span(self, name: str, t0: float, t1: float,
                    trace_id: Optional[int] = None,
                    trace_ids: Optional[tuple] = None, **attrs):
        """Record a RETROSPECTIVE span from timestamps the caller
        already holds (e.g. the queue phase, measured by request
        timestamps) — no live bookkeeping on the hot path."""
        self._record(Span(name, trace_id, t0, t1,
                          tuple(trace_ids) if trace_ids else None, attrs))

    def event(self, name: str, trace_id: Optional[int] = None, **attrs):
        """Instant (zero-duration) span."""
        now = time.monotonic()
        self._record(Span(name, trace_id, now, now, None, attrs))

    # --------------------------------------------------------------- queries
    def spans(self, trace_id: Optional[int] = None,
              name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._ring)
        if trace_id is not None:
            out = [s for s in out if s.in_trace(trace_id)]
        if name is not None:
            out = [s for s in out if s.name == name]
        return out

    def timeline(self, trace_id: int) -> List[dict]:
        """Every span of one trace, oldest-first, offsets relative to
        the trace's first span — the per-request timeline dump.
        ``None`` (a future whose request predates tracing) is NOT a
        wildcard here: it returns an empty timeline, never the whole
        ring dressed up as one request."""
        if trace_id is None:
            return []
        spans = sorted(self.spans(trace_id), key=lambda s: (s.t0, s.t1))
        if not spans:
            return []
        base = spans[0].t0
        out = []
        for s in spans:
            d = s.as_dict()
            d["offset_ms"] = round(1e3 * (s.t0 - base), 4)
            out.append(d)
        return out

    def trace_ids(self) -> List[int]:
        seen: Dict[int, None] = {}
        with self._lock:
            for s in self._ring:
                if s.trace_id is not None:
                    seen.setdefault(s.trace_id, None)
                for t in s.trace_ids:
                    seen.setdefault(t, None)
        return list(seen)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def __len__(self):
        with self._lock:
            return len(self._ring)


# The one active tracer.  Written under _LOCK; read lock-free on hot
# paths (a torn read of a single reference is impossible in CPython).
_ACTIVE: Optional[Tracer] = None
_LOCK = _named_lock("obs.trace_global", "active-tracer swaps")


def _ring_samples():
    """Registry collector: the span ring's occupancy and evictions as
    scrapeable series (docs/observability.md).  ``tracer.dropped``
    used to be visible only on the tracer object — a scraper could
    not tell a quiet host from a ring silently thrashing (every
    dropped span is a hole in some request's timeline).  No samples
    while tracing is disabled: there is no ring to report on, and an
    absent series is distinguishable from a zero one."""
    tr = _ACTIVE
    if tr is None:
        return []
    with tr._lock:
        dropped, size = tr.dropped, len(tr._ring)
    return [
        {"name": "mxtpu_trace_spans_dropped_total", "kind": "counter",
         "labels": {}, "value": dropped,
         "help": "spans evicted by the ring bound — each is a hole in "
                 "some request's timeline (resets when the tracer is "
                 "replaced)"},
        {"name": "mxtpu_trace_ring_spans", "kind": "gauge",
         "labels": {}, "value": size,
         "help": "spans currently in the ring"},
        {"name": "mxtpu_trace_ring_capacity", "kind": "gauge",
         "labels": {}, "value": tr.capacity,
         "help": "ring bound — ring_spans pinned here plus a climbing "
                 "dropped_total means the ring is thrashing"},
    ]


def _register_ring_collector():
    from .registry import default_registry
    default_registry().register_collector("trace", _ring_samples)


_register_ring_collector()


def enable(capacity: int = 4096,
           profiler_markers: bool = False) -> Tracer:
    """Install (or replace) the process-global tracer and return it.
    Replacing drops the previous ring — tracing config is a process
    decision, not a nesting scope like FaultPlan."""
    global _ACTIVE
    tracer = Tracer(capacity=capacity, profiler_markers=profiler_markers)
    with _LOCK:
        _ACTIVE = tracer
    # re-register on every enable: a test that reset() the registry
    # (dropping all collectors) still gets ring telemetry back the
    # moment tracing turns on
    _register_ring_collector()
    return tracer


def disable() -> None:
    global _ACTIVE
    with _LOCK:
        _ACTIVE = None


def active() -> Optional[Tracer]:
    """The hot-path hook: one global load.  Instrumentation sites do
    ``tr = active()`` / ``if tr is not None: ...`` and NOTHING else on
    the disabled path."""
    return _ACTIVE
