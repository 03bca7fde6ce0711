"""Named ranges in the device trace: the part of ``mxnet_tpu/profiler.py``
that the serving metrics and the span tracer use (``Marker``, ``scope``,
``device_span``), over ``torch.profiler.record_function`` where the
reference opens ``jax.profiler.TraceAnnotation``.  A range opened here
lands in a ``torch.profiler`` trace around the CPU ops and the CUDA
kernels it covers (a replayed graph's kernels included); with no
profiler running it costs one record-function call.  The rest of the
reference's profiler (``set_config``, ``set_state``, ``dump``,
``Task``, ``Frame``) is ROADMAP queue A9."""
from __future__ import annotations

import torch

__all__ = ["Marker", "scope", "device_span"]


class _Annotation:
    """A named range (``start``/``stop`` or a ``with`` block)."""

    def __init__(self, name: str):
        self.name = name
        self._ann = None

    def start(self):
        self._ann = torch.profiler.record_function(self.name)
        self._ann.__enter__()

    def stop(self):
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *a):
        self.stop()


class Marker:
    def __init__(self, name: str):
        self.name = name

    def mark(self, scope_="process", value=None):
        """Instant event in the trace; ``value`` (int/float/str) is
        embedded in its name."""
        name = f"marker:{self.name}" if value is None else \
            f"marker:{self.name}={value}"
        with torch.profiler.record_function(name):
            pass

    def span(self):
        """The same marker as a named range (context manager)."""
        return _Annotation(f"marker:{self.name}")


def scope(name: str):
    """Context manager annotating a named range."""
    return _Annotation(name)


class _SafeAnnotation(_Annotation):
    """An annotation that degrades to a no-op if the profiler is
    unusable: a trace decoration must never break the span it
    decorates."""

    def start(self):
        try:
            super().start()
        except Exception:
            self._ann = None

    def stop(self):
        try:
            super().stop()
        except Exception:
            self._ann = None


def device_span(name: str) -> _SafeAnnotation:
    """A named range ``span:<name>`` that never raises: what
    :mod:`mxnet_tpu_torch.observability.trace` opens around a span when
    its tracer has ``profiler_markers=True``."""
    return _SafeAnnotation(f"span:{name}")
