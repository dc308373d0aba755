"""Anomaly detection over recorded series, with a firing/resolved
alert lifecycle that drives the existing control loops.

A copy of the reference's ``repro/obs/anomaly.py`` over the port's
registry and recorder.

Detection is deliberately simple and dependency-free: an
:class:`EwmaDetector` keeps an exponentially-weighted mean and variance
(West 1979 incremental form) and flags a sample whose z-score against
that baseline exceeds a threshold — after a warmup count so the baseline
is learned from the stream itself, not configured.  That is enough for
every signal watched below, because they are all *level* signals:

* ``repro_activity_effective_density{layer}`` — the paper's sparsity
  operating point; a sustained shift means the input distribution moved
  (the drift-detect half of a continual-learning loop);
* ``repro_activity_events_per_frame{layer}`` and
  ``repro_activity_accum_ratio_vs_dense{layer}`` — the Tables I/III
  workload counters, drifting with the same cause;
* ``repro_canary_window_accuracy`` / per-SNR canary accuracy — the
  model-quality signal.

Alerts flow through one :class:`AlertManager`:

* dedup by ``(name, labels)`` — repeated anomalous samples refresh one
  firing alert instead of flooding;
* explicit ``firing -> resolved`` transitions, each pushed to pluggable
  sinks and mirrored in the ``repro_alerts_firing{alert}`` gauge so the
  alert state itself is scrapeable (and recordable, and SLO-able);
* :func:`autoscaler_sink` converts a firing page-severity latency alert
  into scale-up pressure on the existing :class:`~repro_torch.fleet.autoscaler.
  Autoscaler`; :func:`canary_shadow_sink` converts a firing sparsity-
  drift alert into a :class:`~repro_torch.deploy.monitor.CanaryMonitor`
  shadow-evaluation step.  Detection drives the loops that already know
  how to act.

:class:`SeriesWatcher` ties it together: recorder series -> detectors ->
manager, one ``step()`` per recorder sweep.  :class:`BurnRateWatcher`
does the same for :class:`~repro_torch.obs.slo.BurnRateEngine` statuses.
"""
from __future__ import annotations

import json
import math
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import MetricsRegistry, default_registry
from repro_torch.obs.slo import BurnRateEngine, SLOStatus
from repro_torch.obs.timeseries import TimeSeriesRecorder

__all__ = ["EwmaDetector", "Alert", "AlertManager", "WatchSpec",
           "default_drift_watches", "SeriesWatcher", "BurnRateWatcher",
           "autoscaler_sink", "canary_shadow_sink", "log_file_sink",
           "set_default_alert_manager", "get_default_alert_manager"]


class EwmaDetector:
    """EWMA mean/variance z-score detector for one scalar stream.

    ``alpha`` is the smoothing factor (higher = faster-moving baseline);
    ``threshold`` the |z| that flags; ``min_samples`` the warmup before
    any sample can flag (the baseline must be learned first);
    ``direction`` restricts to drops (``"down"``), rises (``"up"``), or
    both.  While a sample is anomalous the baseline is *frozen* — a
    sustained shift keeps flagging instead of being absorbed, and the
    alert resolves only when the signal returns to the learned band.
    """

    def __init__(self, *, alpha: float = 0.1, threshold: float = 4.0,
                 min_samples: int = 8, direction: str = "both",
                 min_std: float = 1e-6):
        if direction not in ("both", "up", "down"):
            raise ValueError(f"bad direction {direction!r}")
        self.alpha = alpha
        self.threshold = threshold
        self.min_samples = min_samples
        self.direction = direction
        self.min_std = min_std
        self.mean = 0.0
        self.var = 0.0          # variance once warm (from Welford M2)
        self._m2 = 0.0          # Welford sum of squared deviations
        self.n = 0

    def update(self, x: float) -> Tuple[bool, float]:
        """Feed one sample; returns (is_anomaly, z_score)."""
        x = float(x)
        if self.n < self.min_samples:
            # warmup: Welford incremental mean/variance
            self.n += 1
            d = x - self.mean
            self.mean += d / self.n
            self._m2 += d * (x - self.mean)
            if self.n == self.min_samples:
                self.var = self._m2 / max(1, self.n - 1)
            return False, 0.0
        std = max(self.min_std, math.sqrt(max(0.0, self.var)))
        z = (x - self.mean) / std
        anomalous = ((self.direction in ("both", "up") and
                      z > self.threshold)
                     or (self.direction in ("both", "down") and
                         z < -self.threshold))
        if not anomalous:
            # EWMA update of mean and variance (frozen while anomalous)
            d = x - self.mean
            incr = self.alpha * d
            self.mean += incr
            self.var = (1 - self.alpha) * (self.var + d * incr)
            self.n += 1
        return anomalous, z


@dataclass
class Alert:
    """One alert instance, dedup-keyed by (name, labels)."""
    name: str
    labels: Tuple[Tuple[str, str], ...] = ()
    severity: str = "page"              # "page" | "ticket"
    state: str = "firing"               # "firing" | "resolved"
    value: float = 0.0
    threshold: float = 0.0
    reason: str = ""
    t_fired: float = 0.0
    t_resolved: Optional[float] = None
    n_refires: int = 0                  # re-triggers while already firing

    @property
    def key(self) -> Tuple:
        return (self.name, self.labels)

    def to_dict(self) -> Dict:
        return {
            "name": self.name, "labels": dict(self.labels),
            "severity": self.severity, "state": self.state,
            "value": self.value, "threshold": self.threshold,
            "reason": self.reason, "t_fired": self.t_fired,
            "t_resolved": self.t_resolved, "n_refires": self.n_refires,
        }


#: sink(alert, transition) where transition is "fire" | "resolve"
AlertSink = Callable[[Alert, str], None]


class AlertManager:
    """Dedup + lifecycle + fan-out for alerts.

    ``fire`` on an already-firing key refreshes it (value/reason update,
    refire count) without re-notifying sinks; ``resolve`` on a firing
    key transitions it and notifies.  The ``repro_alerts_firing{alert}``
    gauge mirrors the firing set so the alerting plane is itself
    observable.  Sink exceptions are swallowed into ``sink_errors`` —
    one broken consumer must not take down detection.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 *, clock: Optional[Callable[[], float]] = None):
        self._registry = registry
        self._clock = clock
        self._lock = threading.Lock()
        self._alerts: Dict[Tuple, Alert] = {}
        self._sinks: List[AlertSink] = []
        self.history: List[Alert] = []
        self.sink_errors = 0

    def _reg(self) -> MetricsRegistry:
        return self._registry if self._registry is not None \
            else default_registry()

    def _gauge(self, alert: Alert) -> None:
        # several label sets can share one alert name (e.g. page+ticket
        # burns): the gauge is the count still firing under that name
        with self._lock:
            n = sum(1 for a in self._alerts.values()
                    if a.name == alert.name and a.state == "firing")
        self._reg().gauge(
            "repro_alerts_firing",
            "Number of firing alert instances under the named alert.",
            labelnames=("alert",)).labels(alert=alert.name).set(float(n))

    def add_sink(self, sink: AlertSink) -> None:
        with self._lock:
            self._sinks.append(sink)

    def _notify(self, alert: Alert, transition: str) -> None:
        with self._lock:
            sinks = list(self._sinks)
        for sink in sinks:
            try:
                sink(alert, transition)
            except Exception:
                with self._lock:
                    self.sink_errors += 1

    # -- lifecycle -----------------------------------------------------------

    def fire(self, name: str, *, labels: Dict[str, str] = None,
             severity: str = "page", value: float = 0.0,
             threshold: float = 0.0, reason: str = "",
             t: Optional[float] = None) -> Alert:
        key = (name, tuple(sorted((labels or {}).items())))
        now = t if t is not None else (self._clock() if self._clock
                                       else 0.0)
        with self._lock:
            existing = self._alerts.get(key)
            if existing is not None and existing.state == "firing":
                existing.value = value
                existing.reason = reason or existing.reason
                existing.n_refires += 1
                return existing
            alert = Alert(name=name, labels=key[1], severity=severity,
                          state="firing", value=value, threshold=threshold,
                          reason=reason, t_fired=now)
            self._alerts[key] = alert
            self.history.append(alert)
        self._gauge(alert)
        self._notify(alert, "fire")
        return alert

    def resolve(self, name: str, *, labels: Dict[str, str] = None,
                t: Optional[float] = None) -> Optional[Alert]:
        key = (name, tuple(sorted((labels or {}).items())))
        now = t if t is not None else (self._clock() if self._clock
                                       else 0.0)
        with self._lock:
            alert = self._alerts.get(key)
            if alert is None or alert.state != "firing":
                return None
            alert.state = "resolved"
            alert.t_resolved = now
        self._gauge(alert)
        self._notify(alert, "resolve")
        return alert

    # -- queries -------------------------------------------------------------

    def firing(self, severity: Optional[str] = None) -> List[Alert]:
        with self._lock:
            out = [a for a in self._alerts.values() if a.state == "firing"]
        if severity is not None:
            out = [a for a in out if a.severity == severity]
        return sorted(out, key=lambda a: a.key)

    def all_alerts(self) -> List[Alert]:
        with self._lock:
            return sorted(self._alerts.values(), key=lambda a: a.key)

    def to_json(self) -> Dict:
        return {
            "firing": [a.to_dict() for a in self.firing()],
            "alerts": [a.to_dict() for a in self.all_alerts()],
            "n_history": len(self.history),
            "sink_errors": self.sink_errors,
        }


# -- watchers: series/SLO statuses -> alerts ---------------------------------

@dataclass
class WatchSpec:
    """One watched (metric, labels) pattern with its detector factory."""
    metric: str
    labels: Tuple[Tuple[str, str], ...] = ()
    alert_name: str = ""
    severity: str = "ticket"
    detector: Callable[[], EwmaDetector] = field(
        default_factory=lambda: (lambda: EwmaDetector()))


#: Stock drift watches over the live activity gauges (sparsity drift is
#: a *drop or rise* in effective density / events-per-frame).
def default_drift_watches() -> List[WatchSpec]:
    mk = lambda: EwmaDetector(alpha=0.15, threshold=4.0, min_samples=8)
    return [
        WatchSpec("repro_activity_effective_density",
                  alert_name="sparsity_drift", severity="ticket",
                  detector=mk),
        WatchSpec("repro_activity_events_per_frame",
                  alert_name="events_per_frame_drift", severity="ticket",
                  detector=mk),
        WatchSpec("repro_activity_accum_ratio_vs_dense",
                  alert_name="accum_ratio_drift", severity="ticket",
                  detector=mk),
        WatchSpec("repro_canary_window_accuracy",
                  alert_name="canary_accuracy_drift", severity="page",
                  detector=lambda: EwmaDetector(
                      alpha=0.15, threshold=4.0, min_samples=8,
                      direction="down")),
    ]


class SeriesWatcher:
    """Feeds new recorder samples through per-series detectors.

    ``step()`` walks each watched series' points appended since the last
    step and updates that series' own detector (one baseline per label
    set — conv1's density does not pollute conv3's).  A flagged sample
    fires the alert; a clean sample on a firing alert resolves it.
    """

    def __init__(self, recorder: TimeSeriesRecorder, manager: AlertManager,
                 watches: Optional[Sequence[WatchSpec]] = None):
        self.recorder = recorder
        self.manager = manager
        self.watches = list(watches if watches is not None
                            else default_drift_watches())
        self._detectors: Dict[Tuple, EwmaDetector] = {}
        self._cursor: Dict[Tuple, float] = {}   # last consumed timestamp

    def step(self) -> List[Alert]:
        fired: List[Alert] = []
        series = self.recorder.series()
        for w in self.watches:
            want = dict(w.labels)
            for s in series:
                if s.name != w.metric or s.kind == "histogram":
                    continue
                have = dict(s.labels)
                if not all(have.get(k) == v for k, v in want.items()):
                    continue
                skey = (w.metric, s.labels)
                det = self._detectors.get(skey)
                if det is None:
                    det = self._detectors[skey] = w.detector()
                last_t = self._cursor.get(skey, float("-inf"))
                alert_name = w.alert_name or f"{w.metric}_anomaly"
                labels = dict(s.labels)
                for t, v in s.points():
                    if t <= last_t:
                        continue
                    last_t = t
                    anomalous, z = det.update(float(v))
                    if anomalous:
                        fired.append(self.manager.fire(
                            alert_name, labels=labels, severity=w.severity,
                            value=float(v), threshold=det.threshold,
                            reason=(f"{w.metric} z={z:+.1f} vs EWMA "
                                    f"mean={det.mean:.4g}"),
                            t=t))
                    else:
                        self.manager.resolve(alert_name, labels=labels, t=t)
                self._cursor[skey] = last_t
        return fired


class BurnRateWatcher:
    """Turns :class:`BurnRateEngine` statuses into burn-rate alerts.

    One alert per (SLO, severity): fires while that window pair breaches
    its factor, resolves when it stops.  Alert names are
    ``slo_burn:<slo>`` with a ``severity`` label, so the autoscaler sink
    can key on page-severity latency burns specifically.
    """

    def __init__(self, engine: BurnRateEngine, manager: AlertManager):
        self.engine = engine
        self.manager = manager

    def step(self, now: Optional[float] = None) -> List[SLOStatus]:
        statuses = self.engine.evaluate(now)
        for st in statuses:
            for w in self.engine.windows:
                labels = {"severity": w.severity}
                name = f"slo_burn:{st.slo.name}"
                if w.severity in st.firing:
                    b_long, b_short = st.burns[w.severity]
                    self.manager.fire(
                        name, labels=labels, severity=w.severity,
                        value=float(b_long or 0.0), threshold=w.factor,
                        reason=(f"burn {b_long:.1f}x/{b_short:.1f}x over "
                                f"{w.long_s:g}s/{w.short_s:g}s windows"),
                        t=st.t)
                else:
                    self.manager.resolve(name, labels=labels, t=st.t)
        return statuses


# -- sinks into the existing control loops -----------------------------------

def autoscaler_sink(autoscaler) -> AlertSink:
    """Firing page-severity burn/latency alerts press the autoscaler up.

    The :class:`~repro_torch.fleet.autoscaler.Autoscaler` exposes
    ``alert_pressure``: while set, its next ``step()`` treats the
    fleet as overloaded regardless of instantaneous p99 — an SLO burn is
    a longer-horizon signal than one tick's latency sample.
    """
    def sink(alert: Alert, transition: str) -> None:
        if alert.severity != "page":
            return
        relevant = (alert.name.startswith("slo_burn:latency")
                    or alert.name.startswith("slo_burn:availability")
                    or "p99" in alert.name)
        if not relevant:
            return
        if transition == "fire":
            autoscaler.set_alert_pressure(alert.name)
        else:
            autoscaler.clear_alert_pressure(alert.name)
    return sink


def canary_shadow_sink(monitor) -> AlertSink:
    """Firing sparsity-drift alerts trigger a canary shadow evaluation.

    Drift in effective density means the input distribution moved; the
    :class:`~repro_torch.deploy.monitor.CanaryMonitor` already knows how to
    shadow-evaluate a candidate under the live distribution — this sink
    just makes detection call it (while a decision is still pending).
    """
    drift_names = ("sparsity_drift", "events_per_frame_drift",
                   "accum_ratio_drift")
    lock = threading.Lock()

    def sink(alert: Alert, transition: str) -> None:
        if transition != "fire" or alert.name not in drift_names:
            return
        with lock:
            if getattr(monitor, "decision", "pending") != "pending":
                return
            monitor.step()
    return sink


def log_file_sink(path: str) -> AlertSink:
    """Append one JSON line per alert transition to ``path``."""
    lock = threading.Lock()

    def sink(alert: Alert, transition: str) -> None:
        line = json.dumps({"transition": transition, **alert.to_dict()},
                          sort_keys=True)
        with lock:
            with open(path, "a") as f:
                f.write(line + "\n")
    return sink


# -- process-wide manager (what the /alerts endpoint serves) -----------------

_manager: Optional[AlertManager] = None
_manager_lock = threading.Lock()


def set_default_alert_manager(
        manager: Optional[AlertManager]) -> Optional[AlertManager]:
    """Install the process-wide alert manager; returns the previous."""
    global _manager
    with _manager_lock:
        old, _manager = _manager, manager
        return old


def get_default_alert_manager() -> Optional[AlertManager]:
    with _manager_lock:
        return _manager
