"""``mxnet_tpu_torch.observability``: the telemetry plane (counterpart
of ``mxnet_tpu/observability/``, the same metric names, span names and
bundle layout).

- :mod:`.registry`: a process-wide, lock-guarded
  :class:`MetricsRegistry` of labeled counters, gauges and histograms
  that the trainer, the resilience loop, the checkpointer and the
  serving metrics register into: one ``collect()`` snapshot covers the
  process under stable metric names.
- :mod:`.trace`: low-overhead span tracing around ``ResilientLoop``
  and ``ShardedTrainer.step``; a bounded ring buffer, per-trace
  timelines, zero-cost when disabled (one global load and a ``None``
  check); with ``profiler_markers=True`` each span is also a
  ``torch.profiler`` range.
- :mod:`.export`: Prometheus text and JSON-lines exporters plus a
  :class:`BackgroundExporter` thread with a graceful drain.
- :mod:`.flightrecorder`: a bounded lifecycle-event ring that on a
  trigger (watchdog trip, SLO breach, explicit ``dump()``) atomically
  writes a debug bundle: the last events, span timelines, a registry
  snapshot, the active fault plan, the lock-witness graph, and the
  torch, CUDA and device facts.
- :mod:`.slo`: declared objectives (:class:`SLO`) evaluated at scrape
  time by :class:`SLOTracker`, exported as ``mxtpu_slo_*`` gauges.

Quick start::

    from mxnet_tpu_torch import observability as obs

    tracer = obs.enable_tracing()               # span recording on
    loop.run(make_iter, steps)                  # a ResilientLoop
    print(obs.to_prometheus(obs.default_registry().collect()))
    print([s.name for s in tracer.spans()])     # loop.step, trainer.step
"""
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       default_registry)
from .trace import (Span, Tracer, active as active_tracer,
                    disable as disable_tracing, enable as enable_tracing)
from .export import (BackgroundExporter, flatten, parse_prometheus,
                     to_json_lines, to_prometheus)
from .flightrecorder import (FlightRecorder,
                             active as active_flight_recorder,
                             disable as disable_flight_recorder,
                             enable as enable_flight_recorder)
from .slo import SLO, SLOTracker

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "default_registry",
    "Span", "Tracer", "enable_tracing", "disable_tracing",
    "active_tracer",
    "BackgroundExporter", "to_prometheus", "to_json_lines",
    "parse_prometheus", "flatten",
    "FlightRecorder", "enable_flight_recorder",
    "disable_flight_recorder", "active_flight_recorder",
    "SLO", "SLOTracker",
]
