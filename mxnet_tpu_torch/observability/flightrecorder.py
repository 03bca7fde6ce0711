"""Failure-time forensics: an always-on event ring + debug bundles
(counterpart of ``mxnet_tpu/observability/flightrecorder.py``).

The metrics registry answers "what are the numbers *now*" and the
tracer answers "what did *this request* do" — neither survives the
moment an operator actually needs them: when the watchdog condemns an
engine its ``stats()`` die with it, the span ring keeps rolling over
the evidence, and the 30 seconds of lifecycle history *before* the
trip (sheds ramping, a NaN storm building, a replica flapping) are
gone.  The **flight recorder** is the blackbox for that moment:

- a bounded, lock-guarded ring of lifecycle **events** fed by the
  edges that already exist — engine submit/shed/preempt/crash,
  watchdog trips, ``ResilientLoop`` rewinds/quarantines, fleet
  deaths/gray ejections/brownouts, page faults and NaN scrubs
  (taxonomy: docs/observability.md);
- **zero-cost when disabled** — every instrumentation site is one
  module-global load plus a ``None`` check, the
  :mod:`~mxnet_tpu_torch.resilience.faults` contract; the serving bench
  medians must stay inside the host-noise band with the recorder off;
- on a **trigger** — watchdog trip, :class:`EngineCrashedError`
  condemnation, a :class:`NonFiniteOutputError` burst, a replica
  death, SIGTERM, an SLO breach (:mod:`.slo`), or an explicit
  :meth:`~FlightRecorder.dump` — it atomically writes a **debug
  bundle** (temp file + ``os.replace``, the
  :class:`~mxnet_tpu_torch.observability.export.BackgroundExporter`
  pattern): the last-N events, span timelines for the implicated
  trace ids, a full registry snapshot, ``stats()`` of every LIVE
  engine (incl. the per-(bucket, mesh)-point compile accounting and
  kv-page occupancy), the active :class:`FaultPlan`, the lock-witness
  graph when enabled, SLO state, and the platform facts: Python, torch
  and CUDA versions and the CUDA devices' names and count (the
  reference records jax's).

Every bundle section is individually fail-safe: a producer mid-
teardown (the condemned engine itself, a collapsing exporter) yields
an ``{"error": ...}`` stanza, never a lost bundle — a forensics dump
that dies of the failure it documents is worthless.  Automatic
triggers are rate-limited (``min_interval``) so a crash loop cannot
fill a disk; explicit ``dump()`` always writes.
"""
from __future__ import annotations

import itertools
import json
import os
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from ..analysis.lockwitness import named_lock as _named_lock

__all__ = ["FlightEvent", "FlightRecorder", "enable", "disable", "active",
           "BUNDLE_SCHEMA_VERSION", "BUNDLE_KIND"]

BUNDLE_SCHEMA_VERSION = 1
#: the bundle's self-identification — ``tools/obs_bundle.py`` refuses
#: anything else, so a truncated or foreign JSON can never half-parse
#: as forensics
BUNDLE_KIND = "mxtpu-flight-bundle"


class FlightEvent:
    """One recorded lifecycle edge: name, monotonic instant, attrs."""

    __slots__ = ("name", "t", "seq", "attrs")

    def __init__(self, name: str, t: float, seq: int, attrs: dict):
        self.name = name
        self.t = t
        self.seq = seq
        self.attrs = attrs

    def as_dict(self) -> dict:
        return {"name": self.name, "t": self.t, "seq": self.seq,
                "attrs": dict(self.attrs)}

    def __repr__(self):
        return f"FlightEvent({self.name!r}, seq={self.seq})"


def _safe(fn, what: str):
    """Run one bundle-section producer; a raising producer becomes an
    error stanza instead of killing the dump (the engine being
    bundled may be the very thing that just crashed)."""
    try:
        return fn()
    except BaseException as e:          # even a SimulatedPreemption in a
        return {"error": f"{what}: {e!r}"}   # collector must not eat the dump


class FlightRecorder:
    """Bounded lifecycle-event ring with triggered debug bundles.

    Parameters
    ----------
    capacity : ring bound (events; oldest evicted, evictions counted).
    bundle_dir : where bundles land; created on first write.  Defaults
        to ``$TMPDIR/mxtpu-flight-<pid>`` so a recorder enabled without
        configuration still captures its crash.
    max_bundles : retention bound — oldest bundles pruned past this.
    bundle_events : how many trailing events a bundle embeds.
    bundle_spans : per implicated trace id, how many spans a bundle
        embeds from the tracer (when tracing is enabled).
    min_interval : seconds between AUTOMATIC bundles — a condemnation
        storm (every replica of a fleet dying at once) must not write
        one bundle per corpse.  Explicit :meth:`dump` ignores it.
    nonfinite_burst / nonfinite_window : a burst is ``>= burst``
        non-finite outputs inside ``window`` seconds; one trigger per
        window (a single NaN request is a data problem, a burst is a
        model/state problem worth a bundle).
    """

    def __init__(self, capacity: int = 2048,
                 bundle_dir: Optional[str] = None,
                 max_bundles: int = 16,
                 bundle_events: int = 256,
                 bundle_spans: int = 64,
                 min_interval: float = 5.0,
                 nonfinite_burst: int = 3,
                 nonfinite_window: float = 10.0):
        self.capacity = int(capacity)
        self.bundle_dir = os.path.abspath(bundle_dir) if bundle_dir else \
            os.path.join(tempfile.gettempdir(),
                         f"mxtpu-flight-{os.getpid()}")
        self.max_bundles = int(max_bundles)
        self.bundle_events = int(bundle_events)
        self.bundle_spans = int(bundle_spans)
        self.min_interval = float(min_interval)
        self.nonfinite_burst = int(nonfinite_burst)
        self.nonfinite_window = float(nonfinite_window)
        self._lock = _named_lock("obs.flightrecorder",
                                 "flight-recorder event ring + "
                                 "bundle bookkeeping")
        self._ring: deque = deque(maxlen=self.capacity)
        self._seq = itertools.count(1)
        # bundle numbering continues from whatever is already on disk:
        # a fresh recorder pointed at the same bundle_dir (process
        # restart after the very crash being debugged, re-enable())
        # must never os.replace() over a prior incident's bundle
        start = 1
        try:
            for n in os.listdir(self.bundle_dir):
                if n.startswith("bundle-") and n.endswith(".json"):
                    try:
                        start = max(start, int(n.split("-")[1]) + 1)
                    except (ValueError, IndexError):
                        pass
        except OSError:
            pass
        self._bundle_seq = itertools.count(start)
        self._nonfinite_ts: deque = deque(maxlen=max(
            1, self.nonfinite_burst))
        self._nonfinite_trigger_at = -1e9
        self._last_auto_bundle = -1e9
        self._dumping = False
        self._dump_thread: Optional[threading.Thread] = None
        self.dropped = 0            # events evicted by the ring bound
        self.bundles_written = 0
        self.bundle_errors = 0
        self.last_bundle: Optional[str] = None

    # ------------------------------------------------------------- recording
    def record(self, name: str, **attrs) -> None:
        """Append one lifecycle event.  Any thread; never raises (a
        telemetry edge must not add a failure mode to the path it
        observes)."""
        try:
            ev = FlightEvent(name, time.monotonic(), next(self._seq),
                             attrs)
            with self._lock:
                if len(self._ring) == self._ring.maxlen:
                    self.dropped += 1
                self._ring.append(ev)
        except Exception:
            pass

    def nonfinite(self, **attrs) -> Optional[str]:
        """Record one ``serving.nonfinite`` event and apply burst
        detection: ``nonfinite_burst`` of them inside
        ``nonfinite_window`` seconds is a trigger (once per window) —
        one poisoned request is the request's problem, a burst means
        shared state or the model itself went bad."""
        self.record("serving.nonfinite", **attrs)
        now = time.monotonic()
        with self._lock:
            self._nonfinite_ts.append(now)
            due = (len(self._nonfinite_ts) >= self.nonfinite_burst
                   and now - self._nonfinite_ts[0]
                   <= self.nonfinite_window
                   and now - self._nonfinite_trigger_at
                   >= self.nonfinite_window)
            if due:
                self._nonfinite_trigger_at = now
                self._nonfinite_ts.clear()
        if due:
            return self.trigger("serving.nonfinite_burst",
                                burst=self.nonfinite_burst,
                                window_s=self.nonfinite_window, **attrs)
        return None

    # -------------------------------------------------------------- triggers
    def trigger(self, name: str, **attrs) -> Optional[str]:
        """A failure-class event worth a bundle: record it, then — if
        no automatic bundle landed inside ``min_interval`` and no dump
        is already in flight — write one.  Returns the bundle path (or
        ``None`` when rate-limited/failed).  Never raises."""
        self.record(name, **attrs)
        try:
            return self._maybe_dump(name, attrs, force=False)
        except Exception:
            return None

    def dump(self, reason: str = "manual.dump", **attrs) -> Optional[str]:
        """Explicit, unconditional bundle (the operator's/chaos
        harness's handle).  Still ``None`` if the write itself failed
        — counted in ``bundle_errors``."""
        self.record(reason, **attrs)
        try:
            return self._maybe_dump(reason, attrs, force=True)
        except Exception:
            return None

    def _maybe_dump(self, name: str, attrs: dict,
                    force: bool) -> Optional[str]:
        me = threading.current_thread()
        deadline = time.monotonic() + 10.0
        while True:
            now = time.monotonic()
            with self._lock:
                if not self._dumping:
                    if not force and now - self._last_auto_bundle \
                            < self.min_interval:
                        return None
                    if not force:
                        self._last_auto_bundle = now
                    self._dumping = True
                    self._dump_thread = me
                    seq = next(self._bundle_seq)
                    events = list(self._ring)[-self.bundle_events:]
                    break
                if self._dump_thread is me:
                    # a bundle section re-triggered us on the SAME
                    # thread (e.g. collect() -> SLO collector ->
                    # breach): genuine re-entrancy, drop it
                    return None
                if not force:
                    return None      # another dump is already capturing
            if now >= deadline:
                # an explicit dump() must not vanish silently: a write
                # wedged for this long is itself an error worth counting
                with self._lock:
                    self.bundle_errors += 1
                return None
            # force=True from ANOTHER thread: the in-flight bundle is
            # someone else's trigger — wait for it, the operator's
            # explicit dump must still be written ("dump always writes")
            time.sleep(0.01)
        try:
            bundle = self._build_bundle(name, attrs, now, events)
            path = self._write_bundle(seq, name, bundle)
            with self._lock:
                self.bundles_written += 1
                self.last_bundle = path
            self.record("recorder.bundle", trigger=name, path=path)
            return path
        except Exception:
            with self._lock:
                self.bundle_errors += 1
            return None
        finally:
            with self._lock:
                self._dumping = False
                self._dump_thread = None

    # --------------------------------------------------------------- queries
    def events(self, name: Optional[str] = None) -> List[FlightEvent]:
        with self._lock:
            out = list(self._ring)
        if name is not None:
            out = [e for e in out if e.name == name]
        return out

    def bundles(self) -> List[str]:
        """Bundle paths on disk, oldest first."""
        try:
            names = [n for n in os.listdir(self.bundle_dir)
                     if n.startswith("bundle-") and n.endswith(".json")]
        except OSError:
            return []
        return [os.path.join(self.bundle_dir, n) for n in sorted(names)]

    def clear(self):
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    def __len__(self):
        with self._lock:
            return len(self._ring)

    # ------------------------------------------------------- bundle assembly
    def _build_bundle(self, name: str, attrs: dict, now: float,
                      events: List[FlightEvent]) -> dict:
        ev_dicts = [e.as_dict() for e in events]
        return {
            "schema_version": BUNDLE_SCHEMA_VERSION,
            "kind": BUNDLE_KIND,
            # epoch stamp for the operator reading the bundle off disk;
            # ordering inside the bundle rides monotonic `t` fields
            "written_at": time.time(),  # mxlint: disable=wall-clock
            "monotonic_now": now,
            "trigger": {"name": name, "attrs": {k: repr(v) if not
                        isinstance(v, (str, int, float, bool, type(None)))
                        else v for k, v in attrs.items()}},
            "events": ev_dicts,
            "traces": _safe(lambda: self._trace_section(ev_dicts, attrs),
                            "traces"),
            "registry": _safe(self._registry_section, "registry"),
            "engines": _safe(self._engines_section, "engines"),
            "slo": _safe(self._slo_section, "slo"),
            "fault_plan": _safe(self._fault_plan_section, "fault_plan"),
            "lockwitness": _safe(self._lockwitness_section, "lockwitness"),
            "recorder": {"capacity": self.capacity,
                         "dropped": self.dropped,  # raceguard: unguarded(bundle metadata snapshot: atomic int read, momentary staleness is harmless)
                         "bundles_written": self.bundles_written,  # raceguard: unguarded(bundle metadata snapshot: atomic int read, momentary staleness is harmless)
                         "bundle_errors": self.bundle_errors},  # raceguard: unguarded(bundle metadata snapshot: atomic int read, momentary staleness is harmless)
            "versions": _safe(self._versions_section, "versions"),
        }

    def _trace_section(self, events: List[dict], attrs: dict) -> dict:
        """Span timelines for the trace ids implicated in the bundled
        events (and the trigger itself) — the per-request story next
        to the process-level one.  Empty when tracing is disabled."""
        from .trace import active as _tr_active
        tr = _tr_active()
        if tr is None:
            return {"enabled": False, "timelines": {}}
        ids: Dict[int, None] = {}
        for src in [attrs] + [e["attrs"] for e in events]:
            tid = src.get("trace_id")
            if isinstance(tid, int):
                ids.setdefault(tid, None)
        timelines = {}
        for tid in list(ids)[-self.bundle_spans:]:
            tl = tr.timeline(tid)
            if tl:
                timelines[str(tid)] = tl[-self.bundle_spans:]
        return {"enabled": True, "dropped": tr.dropped,
                "ring_spans": len(tr), "timelines": timelines}

    def _registry_section(self) -> dict:
        from .registry import default_registry
        return default_registry().collect()

    def _engines_section(self) -> dict:
        """``stats()`` of every LIVE engine, from the serving engine's
        registry of live names: a condemned engine's counters are
        host-side state that survives until GC, which is why the bundle
        snapshots them."""
        from ..serving import engine as _engine_mod
        live = _engine_mod._LIVE_NAMES
        out = {}
        for name in sorted(live.keys()):
            eng = live.get(name)
            if eng is None:
                continue
            out[name] = _safe(eng.stats, f"engine {name} stats")
        return out

    def _slo_section(self) -> list:
        from . import slo as _slo
        return _slo.tracker_snapshots()

    def _fault_plan_section(self) -> Optional[dict]:
        from ..resilience import faults as _faults
        plan = _faults.active_plan()
        if plan is None:
            return None
        return {"repr": repr(plan), "seed": plan.seed,
                "specs": [repr(s) for s in plan.specs],
                "log": [list(e) for e in plan.log[-64:]]}

    def _lockwitness_section(self) -> Optional[dict]:
        from ..analysis import lockwitness as _lw
        w = _lw.active_witness()
        if w is None:
            return None
        rep = w.report()
        # the graph, not the raw acquisition stream — bundles must stay
        # readable, and the ordering graph IS the deadlock evidence
        return {k: rep.get(k) for k in
                ("nodes", "edges", "acquisitions", "cycles", "findings",
                 "edge_list")}

    def _versions_section(self) -> dict:
        out = {"python": sys.version.split()[0],
               "platform": sys.platform, "pid": os.getpid()}
        try:
            import torch
            out["torch"] = torch.__version__
            out["cuda"] = torch.version.cuda
            n = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            out["device_count"] = n
            out["devices"] = [torch.cuda.get_device_name(i)
                              for i in range(n)]
        except Exception as e:
            out["torch"] = f"unavailable: {e!r}"
        try:
            import numpy
            out["numpy"] = numpy.__version__
        except Exception:
            pass
        return out

    # ---------------------------------------------------------- bundle write
    def _write_bundle(self, seq: int, name: str, bundle: dict) -> str:
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in name)[:48]
        os.makedirs(self.bundle_dir, exist_ok=True)
        path = os.path.join(self.bundle_dir,
                            f"bundle-{seq:04d}-{safe}.json")
        fd, tmp = tempfile.mkstemp(dir=self.bundle_dir,
                                   prefix=".bundle-tmp-")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(bundle, f, indent=1, default=repr)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)        # atomic publish
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self._prune()
        return path

    def _prune(self):
        paths = self.bundles()
        for p in paths[:max(0, len(paths) - self.max_bundles)]:
            try:
                os.unlink(p)
            except OSError:
                pass

    def __repr__(self):
        return (f"FlightRecorder(events={len(self)}, "
                f"bundles={self.bundles_written}, "  # raceguard: unguarded(repr diagnostic: atomic int read, momentary staleness is harmless)
                f"dir={self.bundle_dir!r})")


# The one active recorder.  Written under _LOCK; read lock-free on the
# hot paths (a torn read of a single reference is impossible in
# CPython) — the faults.py / trace.py pattern.
_ACTIVE: Optional[FlightRecorder] = None
_LOCK = _named_lock("obs.flightrecorder_global", "active-recorder swaps")


def enable(**kw) -> FlightRecorder:
    """Install (or replace) the process-global flight recorder and
    return it.  Replacing drops the previous ring — like tracing,
    recorder config is a process decision."""
    global _ACTIVE
    fr = FlightRecorder(**kw)
    with _LOCK:
        _ACTIVE = fr
    return fr


def disable() -> None:
    global _ACTIVE
    with _LOCK:
        _ACTIVE = None


def active() -> Optional[FlightRecorder]:
    """The hot-path hook: one global load.  Instrumentation sites do
    ``fr = active()`` / ``if fr is not None: ...`` and NOTHING else on
    the disabled path."""
    return _ACTIVE
