"""A small liveness watchdog thread.

Generic mechanism shared by the serving engine (dead/hung scheduler
detection) and available to any other long-running loop: poll a
``check()`` callable at an interval; the first non-``None`` return is
the trip reason — call ``on_trip(reason)`` once and exit.  The watchdog
never retries after a trip (a tripped engine is condemned; recovery is a
fresh one) and is a daemon thread, so a hung monitored thread can never
keep the process alive through it.
"""
from __future__ import annotations

import threading
from typing import Callable, Optional

__all__ = ["Watchdog"]


class Watchdog(threading.Thread):
    """Poll ``check`` every ``interval`` seconds until it reports a
    problem or :meth:`stop` is called.

    ``check() -> Optional[str]``: ``None`` means healthy; a string is
    the trip reason.  ``on_trip(reason)`` runs on the watchdog thread;
    exceptions it raises are swallowed (the trip is already recorded via
    ``tripped``/``trip_reason`` and a failed handler must not kill the
    report).
    """

    def __init__(self, check: Callable[[], Optional[str]],
                 on_trip: Callable[[str], None],
                 interval: float = 0.1, name: str = "watchdog"):
        super().__init__(name=name, daemon=True)
        self._check = check
        self._on_trip = on_trip
        self.interval = float(interval)
        self._stop_ev = threading.Event()
        self.tripped = False
        self.trip_reason: Optional[str] = None

    def run(self):
        while not self._stop_ev.wait(self.interval):
            try:
                reason = self._check()
            except Exception as e:   # a broken probe is itself a trip
                reason = f"watchdog check failed: {e!r}"
            if reason is not None:
                self.tripped = True
                self.trip_reason = reason
                # observability: trips are rare and load-bearing — both
                # the fleet counter and the trace ring should carry them
                # even when the monitored loop's own metrics are dead
                try:
                    from ..observability.registry import default_registry
                    from ..observability.trace import active as _tr_active
                    default_registry().counter(
                        "mxtpu_watchdog_trips_total",
                        help="watchdog condemnations, any monitored loop",
                        watchdog=self.name).inc()
                    tr = _tr_active()
                    if tr is not None:
                        tr.event("watchdog.trip", watchdog=self.name,
                                 reason=reason)
                except Exception:
                    pass           # telemetry must never mask the trip
                try:
                    # a trip is a flight-recorder TRIGGER: bundle the
                    # process state BEFORE on_trip condemns anything —
                    # the evidence of why dies with the monitored loop
                    from ..observability.flightrecorder import \
                        active as _fr_active
                    fr = _fr_active()
                    if fr is not None:
                        fr.trigger("watchdog.trip", watchdog=self.name,
                                   reason=reason)
                except Exception:
                    pass
                try:
                    self._on_trip(reason)
                finally:
                    return

    def stop(self, join_timeout: Optional[float] = 1.0):
        self._stop_ev.set()
        if self.is_alive() and join_timeout:
            self.join(join_timeout)
