"""SLO-driven elastic fleet control: the autoscaler policy thread.

Counterpart of ``mxnet_tpu/fleet/autoscaler.py``: the same names, options,
counters, lock sites and fault sites, over the port's engines.

The :class:`FleetAutoscaler` closes the loop between the observability
tier and fleet membership (ROADMAP item 3, docs/fleet.md "Elastic
fleet").  Every ``interval`` it reads three aggregate signals off the
HEALTHY replicas:

- **SLO burn rate** — per-replica :class:`~mxnet_tpu_torch.observability.
  slo.SLOTracker` instances (``register=False``: policy-private, not
  scrape-published), reduced to the fleet max.  Burn ≥ 1 means the
  error budget is being spent faster than the window earns it.
- **Error-budget remaining** — the fleet min; a negative value means
  some replica has already blown its budget.
- **Queue pressure / slot utilisation** — the same queue-depth and
  active-slot gauges routing reads, reduced to fleet max (pressure)
  and mean (utilisation).

and turns them into at most one membership action per tick through the
router's :meth:`~mxnet_tpu_torch.fleet.router.FleetRouter.scale_up` /
:meth:`~mxnet_tpu_torch.fleet.router.FleetRouter.scale_down` — the existing
factory rebuild + re-warm path, so a newcomer never compiles on live
traffic and HRW remaps only ~1/N of the keyspace.

**Hysteresis and cooldown** keep oscillating load from thrashing
rebuilds: evidence must persist for ``up_cycles`` (resp.
``down_cycles``) consecutive ticks before an action fires, and each
action arms a cooldown (``up_cooldown`` / ``down_cooldown``) during
which no further action of either direction fires.  Scale-down demands
strictly quieter evidence than scale-up stops at — the dead band
between ``burn_down``/``queue_low`` and ``burn_up``/``queue_high`` is
where a steady fleet lives.

**Fleet-coordinated overload**: with ``coordinate=True`` the
autoscaler also drives every replica's brownout factor cap and
deadline-admission safety from the AGGREGATE pressure fraction, via
:meth:`~mxnet_tpu_torch.serving.InferenceEngine.coordinate_overload`.  One
hot replica (pressure fraction below ½) never drags the fleet into
brownout while its siblings idle; majority pressure throttles the cap
multiplicatively for everyone and stretches admission estimates, and
calm ticks recover it additively — the same AIMD shape as the local
controller.

Every scaling decision is recorded as a flight-recorder lifecycle
event (``fleet.scale_up`` / ``fleet.scale_down``, emitted by the
router) carrying the signal values that justified it, so a forensics
bundle answers "why did the fleet grow at t=412?" without replaying
logs.

A replica in a DELIBERATE drain (manual ``drain()`` /
``rolling_restart()``) vetoes the whole tick: the shrinking fleet and
the victim's rising queue are expected during an upgrade, not evidence
of load — counting them would scale up into a restart and shrink right
after it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..analysis.lockwitness import named_lock as _named_lock
from ..serving.errors import ServingError

__all__ = ["FleetAutoscaler"]


class FleetAutoscaler:
    """Grow/shrink a :class:`~mxnet_tpu_torch.fleet.FleetRouter` from SLO and
    saturation signals.

    Parameters
    ----------
    router : the fleet to govern; must have been built with a
        ``factory`` (scale-up constructs replicas through it).
    slo : optional :class:`~mxnet_tpu_torch.observability.slo.SLO`; when
        given, a private tracker per replica engine feeds burn-rate and
        budget-remaining into the decision.  Without it the policy runs
        on queue/utilisation signals alone.
    min_replicas, max_replicas : membership clamp.  The autoscaler
        repairs a fleet below ``min_replicas`` immediately (no
        hysteresis — that is a hole, not an oscillation).
    interval : policy period in seconds (the thread's cadence; tests
        call :meth:`tick` directly for determinism).
    burn_up, queue_high, budget_floor : scale-UP evidence — any one of
        fleet-max burn ≥ ``burn_up``, fleet-max queue ≥ ``queue_high``
        (default: the router's spill depth), or fleet-min budget
        remaining < ``budget_floor``.
    burn_down, queue_low, util_low : scale-DOWN evidence — ALL of
        fleet-max burn ≤ ``burn_down``, fleet-max queue ≤ ``queue_low``
        and mean slot utilisation ≤ ``util_low``.
    up_cycles, down_cycles : consecutive ticks the evidence must
        persist (hysteresis).
    up_cooldown, down_cooldown : seconds after an action during which
        no further action fires.
    coordinate : drive fleet-wide brownout cap + deadline safety from
        aggregate pressure (see module docstring).
    deadline_safety_max : admission-estimate multiplier at full fleet
        pressure; 1.0 disables the stretch.
    """

    def __init__(self, router, *, slo=None,
                 min_replicas: int = 1, max_replicas: int = 4,
                 interval: float = 0.05,
                 burn_up: float = 1.0, burn_down: float = 0.1,
                 budget_floor: float = 0.0,
                 queue_high: Optional[int] = None, queue_low: int = 1,
                 util_low: float = 0.5,
                 up_cycles: int = 2, down_cycles: int = 4,
                 up_cooldown: float = 0.5, down_cooldown: float = 1.0,
                 coordinate: bool = True,
                 deadline_safety_max: float = 2.0):
        if min_replicas < 1:
            raise ServingError("min_replicas must be >= 1 — an empty "
                               "fleet serves nothing")
        if max_replicas < min_replicas:
            raise ServingError(
                f"max_replicas={max_replicas} < min_replicas="
                f"{min_replicas}")
        if router.factory is None:
            raise ServingError(
                "FleetAutoscaler needs a router built with factory= — "
                "scale-up constructs replicas through it")
        if deadline_safety_max < 1.0:
            raise ServingError("deadline_safety_max must be >= 1.0")
        self.router = router
        self.slo = slo
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.interval = float(interval)
        self.burn_up = float(burn_up)
        self.burn_down = float(burn_down)
        self.budget_floor = float(budget_floor)
        self.queue_high = int(queue_high) if queue_high is not None \
            else int(router.spill_queue_depth)
        self.queue_low = int(queue_low)
        self.util_low = float(util_low)
        self.up_cycles = max(1, int(up_cycles))
        self.down_cycles = max(1, int(down_cycles))
        self.up_cooldown = float(up_cooldown)
        self.down_cooldown = float(down_cooldown)
        self.coordinate = bool(coordinate)
        self.deadline_safety_max = float(deadline_safety_max)
        # decision state: streak counters, cooldown stamp, fleet cap.
        # tick() may be driven by the policy thread or directly by
        # tests/benches, so the state is lock-guarded.
        self._lock = _named_lock("fleet.autoscaler",
                                 "autoscaler decision state")
        self._up_streak = 0
        self._down_streak = 0
        self._cooldown_until = 0.0
        self._cap = 1.0
        self._trackers: Dict[int, tuple] = {}   # id(engine) -> (eng, trk)
        self.ticks = 0
        self.actions: List[dict] = []
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ------------------------------------------------------------- signals
    def _burn(self, handles) -> tuple:
        """(fleet-max burn rate, fleet-min budget remaining) over the
        healthy replicas' private SLO trackers; (0.0, None) without an
        SLO.  Trackers are created lazily per ENGINE OBJECT — a rebuilt
        replica gets a fresh tracker with a fresh baseline — and pruned
        when their engine leaves the fleet."""
        if self.slo is None:
            return 0.0, None
        from ..observability.slo import SLOTracker
        live = set()
        burn, budget = 0.0, None
        for h in handles:
            eng = h.engine
            key = id(eng)
            live.add(key)
            pair = self._trackers.get(key)
            if pair is None or pair[0] is not eng:
                try:
                    pair = (eng, SLOTracker(self.slo, eng,
                                            register=False))
                except Exception:
                    continue
                self._trackers[key] = pair
            try:
                records = pair[1].evaluate()
            except Exception:
                continue
            for rec in records:
                burn = max(burn, rec["burn_rate"])
                rem = rec["budget_remaining"]
                budget = rem if budget is None else min(budget, rem)
        for key in list(self._trackers):
            if key not in live:
                del self._trackers[key]
        return burn, budget

    def _signals(self) -> dict:
        """One consistent-enough reading of the aggregate fleet state.
        Gauges are sampled racily (they are atomic reads off live
        engines); the hysteresis streaks absorb single-tick jitter."""
        handles = self.router._healthy()
        queues, utils = [], []
        for h in handles:
            q = h.queue_depth()
            if q >= (1 << 30):          # unreadable replica: skip, the
                continue                 # health monitor owns that story
            queues.append(q)
            eng = h.engine
            try:
                slots = max(1, eng.num_slots)
                active = eng._alloc.active_count \
                    if eng._alloc is not None else 0
                utils.append(min(1.0, active / slots))
            except Exception:
                pass
        burn, budget = self._burn(handles)
        n = len(handles)
        queue_max = max(queues) if queues else 0
        pressured = sum(1 for q in queues if q >= self.queue_high)
        return {
            "replicas": n,
            "queue_max": queue_max,
            "queue_mean": round(sum(queues) / len(queues), 3)
            if queues else 0.0,
            "util_mean": round(sum(utils) / len(utils), 4)
            if utils else 0.0,
            "burn_rate": round(burn, 4),
            "budget_remaining": budget if budget is None
            else round(budget, 6),
            "pressured_frac": round(pressured / n, 4) if n else 0.0,
        }

    # -------------------------------------------------------- coordination
    def _coordinate(self, sig: dict) -> None:
        """AIMD on the fleet-wide brownout cap, driven by the fraction
        of replicas under queue pressure — NOT by any single replica's
        local panic.  Majority pressure throttles everyone; calm ticks
        recover additively.  Deadline-admission safety stretches with
        the same fraction, so a loaded fleet quotes conservatively
        before it sheds."""
        frac = sig["pressured_frac"]
        if frac >= 0.5:
            self._cap = max(0.0, self._cap * 0.7)   # engine clamps to floor
        elif frac == 0.0 and self._cap < 1.0:
            self._cap = min(1.0, self._cap + 0.1)
        safety = 1.0 + frac * (self.deadline_safety_max - 1.0)
        for h in self.router._healthy():
            try:
                h.engine.coordinate_overload(factor_cap=self._cap,
                                             deadline_safety=safety)
            except Exception:
                continue            # a dying replica is the monitor's job

    # ------------------------------------------------------------ decision
    def tick(self) -> dict:
        """One policy evaluation; at most one membership action.
        Returns the decision record (also appended to ``actions`` when
        an action fired) — benches and tests drive this directly."""
        with self._lock:
            return self._tick_locked()

    def _tick_locked(self) -> dict:
        self.ticks += 1
        r = self.router
        if r._stopping:  # raceguard: unguarded(one-way stop flag: atomic bool read; the stop path itself serializes under _stop_lock)
            return {"action": "hold", "reason": "router stopped"}
        # manual-drain veto (drain-vs-autoscaler race): a deliberate
        # drain makes every signal lie — the fleet looks smaller and
        # the survivors look hotter.  Hold everything, including the
        # streak counters, until the operator's action completes.
        draining = r.draining()
        if draining:
            r._count("scale_vetoes")
            return {"action": "veto", "reason": "manual drain in flight",
                    "draining": draining}
        sig = self._signals()
        if self.coordinate:
            self._coordinate(sig)
        n = sig["replicas"]
        now = time.monotonic()
        # floor repair bypasses hysteresis: below min is a hole in the
        # fleet (deaths beyond the monitor's rebuild lag), not noise
        if 0 < n < self.min_replicas:
            return self._act("up", sig, reason="below min_replicas")
        up_evidence = (
            sig["burn_rate"] >= self.burn_up
            or sig["queue_max"] >= self.queue_high
            or (sig["budget_remaining"] is not None
                and sig["budget_remaining"] < self.budget_floor))
        down_evidence = (
            sig["burn_rate"] <= self.burn_down
            and sig["queue_max"] <= self.queue_low
            and sig["util_mean"] <= self.util_low)
        self._up_streak = self._up_streak + 1 if up_evidence else 0
        self._down_streak = self._down_streak + 1 if down_evidence else 0
        if now < self._cooldown_until:
            return {"action": "hold", "reason": "cooldown", "signals": sig}
        if (up_evidence and self._up_streak >= self.up_cycles
                and n < self.max_replicas):
            return self._act("up", sig, reason="sustained pressure")
        if (down_evidence and self._down_streak >= self.down_cycles
                and n > self.min_replicas):
            return self._act("down", sig, reason="sustained idle")
        return {"action": "hold", "signals": sig}

    def _act(self, direction: str, sig: dict, *, reason: str) -> dict:
        """Fire one membership action through the router's elastic
        path.  The router records the flight-recorder lifecycle event
        with these signals attached; a faulted action (fault sites
        ``fleet.scale_up`` / ``fleet.scale_down``) comes back as
        ``None`` — a counted no-op, retried by later ticks once the
        evidence persists again."""
        now = time.monotonic()
        fr_sig = {f"sig_{k}": v for k, v in sig.items() if v is not None}
        fr_sig["reason"] = reason
        try:
            if direction == "up":
                replica = self.router.scale_up(signals=fr_sig)
                self._cooldown_until = now + self.up_cooldown
            else:
                replica = self.router.scale_down(signals=fr_sig)
                self._cooldown_until = now + self.down_cooldown
        except ServingError as e:
            return {"action": "hold", "reason": f"{direction} refused: "
                    f"{e}", "signals": sig}
        self._up_streak = self._down_streak = 0
        rec = {"action": direction if replica is not None else "faulted",
               "replica": replica, "reason": reason, "signals": sig}
        self.actions.append(rec)
        return rec

    # -------------------------------------------------------------- thread
    def start(self) -> "FleetAutoscaler":
        if self._thread is not None:
            raise ServingError("autoscaler already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="mxnet_tpu_torch-fleet-autoscaler",
            daemon=True)
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:
                # the policy thread must outlive any single bad read; a
                # persistent failure shows up as a frozen ticks counter
                continue

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            # a tick can be mid scale_up (factory build + warmup), which
            # on a cold compile cache takes far longer than one interval;
            # wait it out so callers observe the fired action's effects
            t.join(timeout=60.0)
            if not t.is_alive():
                self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # --------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            return {
                "ticks": self.ticks,
                "actions": list(self.actions),
                "fleet_cap": round(self._cap, 4),
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                "cooldown_remaining": round(max(
                    0.0, self._cooldown_until - time.monotonic()), 3),
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
            }

    def __repr__(self):
        return (f"FleetAutoscaler(replicas=[{self.min_replicas},"
                f"{self.max_replicas}], ticks={self.ticks}, "
                f"actions={len(self.actions)})")
