"""``mx.profiler`` (counterpart of ``mxnet_tpu/profiler.py``) over
``torch.profiler``.

``set_state('run')`` starts a ``torch.profiler.profile`` session, with
the CUDA activity whenever a card is present, where the reference starts
a ``jax.profiler`` trace; ``'stop'`` (or ``pause``) ends it and writes
its Chrome-trace JSON (``trace-<n>.json``: CPU ops, CUDA kernels, and
every named range) into a directory derived from ``set_config``'s
``filename`` as the reference derives its logdir
(``<stem>_torch_profile``), which ``dump`` returns and ``dumps`` names
with its file count.  ``resume`` starts a new session and so a new file.
Starting while another ``torch.profiler`` session is active raises
``MXNetError``: torch runs one profiler at a time.

``Task``, ``Frame``, ``Marker``, ``scope`` and ``device_span`` are named
ranges over ``torch.profiler.record_function``, which land in a trace
around the CPU ops and the CUDA kernels they cover (a replayed graph's
kernels included); with no profiler running a range costs one
record-function call.  The serving metrics and the span tracer use
``Marker`` and ``device_span``.
"""
from __future__ import annotations

import os
import time

import torch

from . import base as _base

__all__ = ["set_config", "set_state", "dump", "dumps", "pause", "resume",
           "Task", "Frame", "Marker", "scope", "device_span"]

_config = {
    "filename": "profile.json",
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": True,
    "profile_api": True,
    "aggregate_stats": False,
}
_state = {"running": False, "dir": None, "t0": None, "prof": None,
          "paused": False, "traces": 0}


def set_config(**kwargs):
    """Accepts MXNet's profiler settings; ``filename`` decides the dump
    directory."""
    _config.update(kwargs)


def _logdir():
    return os.path.splitext(_config["filename"])[0] + "_torch_profile"


def set_state(state="stop", profile_process="worker"):
    """``'run'`` starts a profiling session, ``'stop'`` ends it and
    writes its trace."""
    if state == "run" and not _state["running"]:
        if torch._C._autograd._profiler_enabled():
            raise _base.MXNetError(
                "mx.profiler.set_state('run'): another torch.profiler "
                "session is active in this process, and torch profiles "
                "one session at a time; stop it first")
        logdir = _logdir()
        os.makedirs(logdir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        _state.update(running=True, dir=logdir, t0=time.time(), prof=prof)
    elif state == "stop" and _state["running"]:
        prof = _state["prof"]
        prof.stop()
        path = os.path.join(_state["dir"], f"trace-{_state['traces']}.json")
        prof.export_chrome_trace(path)
        _state.update(running=False, prof=None, traces=_state["traces"] + 1)


def pause(profile_process="worker"):
    """Stop collecting (the session ends and its trace is written);
    :func:`resume` starts a new one."""
    if _state["running"]:
        set_state("stop")
        _state["paused"] = True


def resume(profile_process="worker"):
    if _state.get("paused"):
        set_state("run")
        _state["paused"] = False


def dump(finished=True, profile_process="worker"):
    """End the session if one runs; returns the directory holding the
    traces (derived from ``set_config(filename=...)``)."""
    if _state["running"]:
        set_state("stop")
    return _state["dir"]


def dumps(reset=False):
    """Where the traces are, and how many files (``mx.profiler.dumps``)."""
    d = _state["dir"]
    if d is None:
        return "(profiler never ran)"
    n = sum(len(files) for _, _, files in os.walk(d))
    return (f"Profile data in {d} ({n} files): Chrome-trace JSON, load "
            f"with chrome://tracing or ui.perfetto.dev")


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


class Task(_Annotation):
    pass


class Frame(_Annotation):
    pass


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
