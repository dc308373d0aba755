"""Autoscaler: a p99/utilization control loop over a :class:`FleetRouter`.

The control law is deliberately boring — production autoscalers live or
die on predictability, not cleverness:

* **scale up** when the fleet is visibly past its latency budget:
  recent p99 above ``target_p99_ms``, *or* requests shed / expired since
  the last tick, *or* windowed worker utilization above
  ``high_utilization`` — sustained for ``up_patience`` consecutive ticks;
* **scale down** when the fleet is comfortably idle: p99 under
  ``down_ratio * target_p99_ms``, no shedding/expiry, queue empty-ish,
  and utilization under ``low_utilization`` — sustained for
  ``down_patience`` ticks (down is slower than up: adding capacity late
  costs tail latency, removing it late costs only money);
* every action starts a ``cooldown_ticks`` refractory window so the loop
  never flaps on its own transient (a fresh replica's warmup blip must
  not trigger the next decision).

``step()`` is a single deterministic control tick — the unit the tests
drive directly; ``start()``/``stop()`` run the same tick on a daemon
thread every ``interval_s`` for live deployments.  Every tick appends an
:class:`AutoscaleTick` to ``trace``.

Port of the reference's ``repro/fleet/autoscaler.py`` (stdlib only).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs.metrics import default_registry

__all__ = ["AutoscaleTick", "Autoscaler"]


@dataclasses.dataclass(frozen=True)
class AutoscaleTick:
    """One control-loop observation + the action it produced."""

    tick: int
    t: float
    n_replicas: int
    p99_ms: float
    queue_depth: int
    utilization: float        # windowed: busy-seconds delta / capacity
    shed_delta: int           # requests shed since the previous tick
    expired_delta: int        # deadlines blown since the previous tick
    action: str               # "scale-up" | "scale-down" | "hold"
    reason: str

    def summary(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


class Autoscaler:
    """Grow/shrink a fleet against a p99 target and utilization band.

    ``fleet`` needs only the control surface: ``signals()``,
    ``scale_up()``, ``scale_down()`` (the tests drive a fake) — a
    :class:`~repro_torch.fleet.router.FleetRouter` in production.
    """

    def __init__(
        self,
        fleet,
        *,
        target_p99_ms: float,
        high_utilization: float = 0.75,
        low_utilization: float = 0.20,
        down_ratio: float = 0.5,
        up_patience: int = 1,
        down_patience: int = 4,
        cooldown_ticks: int = 2,
        interval_s: float = 0.5,
        clock=time.perf_counter,
    ):
        if target_p99_ms <= 0:
            raise ValueError(f"target_p99_ms must be > 0, got {target_p99_ms}")
        if not 0 <= low_utilization < high_utilization <= 1:
            raise ValueError(
                f"need 0 <= low < high <= 1 utilization, got "
                f"{low_utilization}/{high_utilization}")
        self.fleet = fleet
        self.target_p99_ms = target_p99_ms
        self.high_utilization = high_utilization
        self.low_utilization = low_utilization
        self.down_ratio = down_ratio
        self.up_patience = max(1, up_patience)
        self.down_patience = max(1, down_patience)
        self.cooldown_ticks = max(0, cooldown_ticks)
        self.interval_s = interval_s
        self._clock = clock
        self.trace: List[AutoscaleTick] = []
        self._tick = 0
        self._breach_ticks = 0
        self._idle_ticks = 0
        self._cooldown = 0
        self._last: Optional[Dict[str, Any]] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # alert-driven scale-up pressure (repro_torch.obs.anomaly sinks): while
        # any named alert is pressing, every tick counts as overloaded —
        # an SLO burn is a longer-horizon signal than one tick's p99
        self._pressure_lock = threading.Lock()
        self._alert_pressure: set = set()
        # structured registry mirror of every control tick: action-labeled
        # tick counter plus the raw signals the decision was made on
        reg = default_registry()
        self._m_ticks = reg.counter(
            "repro_autoscale_ticks_total",
            "Autoscaler control ticks by resulting action", ("action",))
        self._m_p99 = reg.gauge(
            "repro_autoscale_p99_ms", "Fleet p99 (ms) at the last tick")
        self._m_util = reg.gauge(
            "repro_autoscale_utilization",
            "Windowed worker utilization at the last tick")
        self._m_depth = reg.gauge(
            "repro_autoscale_queue_depth",
            "Fleet queue depth at the last tick")
        self._m_replicas = reg.gauge(
            "repro_autoscale_replicas",
            "Replica count observed at the last tick")

    # -- alert pressure (the obs anomaly/burn-rate sink surface) -------------

    def set_alert_pressure(self, name: str) -> None:
        """Press scale-up while the named alert fires (idempotent)."""
        with self._pressure_lock:
            self._alert_pressure.add(name)

    def clear_alert_pressure(self, name: str) -> None:
        with self._pressure_lock:
            self._alert_pressure.discard(name)

    def alert_pressure(self) -> List[str]:
        with self._pressure_lock:
            return sorted(self._alert_pressure)

    # -- one deterministic control tick -------------------------------------

    def _utilization(self, sig: Dict[str, Any]) -> float:
        """Windowed busy fraction between the previous tick and this one.
        The busy seconds of batches flushed at a worker's short hold
        (``held_busy_s``) are left out: an idle worker takes those steps
        early because it has the time, so they are not load."""
        if self._last is None:
            return 0.0
        dt = sig["t"] - self._last["t"]
        workers = max(1, sig.get("workers", 1))
        if dt <= 0:
            return 0.0
        busy = ((sig.get("busy_s", 0.0) - sig.get("held_busy_s", 0.0))
                - (self._last.get("busy_s", 0.0)
                   - self._last.get("held_busy_s", 0.0)))
        return min(1.0, max(0.0, busy / (dt * workers)))

    def step(self) -> AutoscaleTick:
        """Observe the fleet, decide, (maybe) act, and record the tick."""
        sig = self.fleet.signals()
        util = self._utilization(sig)
        last = self._last or {}
        shed_delta = int(sig.get("shed", 0) - last.get("shed", 0))
        expired_delta = int(sig.get("expired", 0) - last.get("expired", 0))
        self._last = sig
        p99 = float(sig.get("p99_ms", 0.0))
        depth = int(sig.get("queue_depth", 0))
        n = int(sig.get("n_replicas", 1))

        pressure = self.alert_pressure()
        overloaded = (p99 > self.target_p99_ms or shed_delta > 0
                      or expired_delta > 0 or util > self.high_utilization
                      or bool(pressure))
        idle = (p99 < self.down_ratio * self.target_p99_ms
                and shed_delta == 0 and expired_delta == 0
                and util < self.low_utilization and depth <= n
                and not pressure)
        self._breach_ticks = self._breach_ticks + 1 if overloaded else 0
        self._idle_ticks = self._idle_ticks + 1 if idle else 0

        action, reason = "hold", ""
        if self._cooldown > 0:
            self._cooldown -= 1
            reason = f"cooldown ({self._cooldown} ticks left)"
        elif overloaded and self._breach_ticks >= self.up_patience:
            why = []
            if p99 > self.target_p99_ms:
                why.append(f"p99 {p99:.1f}ms > target {self.target_p99_ms}ms")
            if shed_delta:
                why.append(f"{shed_delta} shed")
            if expired_delta:
                why.append(f"{expired_delta} expired")
            if util > self.high_utilization:
                why.append(f"util {util:.2f} > {self.high_utilization}")
            if pressure:
                why.append(f"alert pressure: {', '.join(pressure)}")
            added = self.fleet.scale_up()
            if added is not None:
                action = "scale-up"
                reason = f"{'; '.join(why)} -> +{added}"
                self._cooldown = self.cooldown_ticks
                self._breach_ticks = 0
            else:
                reason = f"{'; '.join(why)} (at max replicas)"
        elif idle and self._idle_ticks >= self.down_patience:
            removed = self.fleet.scale_down()
            if removed is not None:
                action = "scale-down"
                reason = (f"idle: p99 {p99:.1f}ms, util {util:.2f} "
                          f"-> -{removed}")
                self._cooldown = self.cooldown_ticks
                self._idle_ticks = 0
            else:
                reason = "idle (at min replicas)"

        tick = AutoscaleTick(
            tick=self._tick, t=float(sig.get("t", self._clock())),
            n_replicas=n, p99_ms=p99, queue_depth=depth, utilization=util,
            shed_delta=shed_delta, expired_delta=expired_delta,
            action=action, reason=reason)
        self._tick += 1
        self.trace.append(tick)
        self._m_ticks.labels(action=action).inc()
        self._m_p99.set(p99)
        self._m_util.set(util)
        self._m_depth.set(depth)
        self._m_replicas.set(n)
        return tick

    def trace_summary(self) -> List[Dict[str, Any]]:
        return [t.summary() for t in self.trace]

    # -- background loop ----------------------------------------------------

    def start(self) -> None:
        """Run ``step()`` every ``interval_s`` on a daemon thread."""
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                self.step()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-autoscaler")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
