"""Declarative SLOs evaluated by a multi-window burn-rate engine.

A copy of the reference's ``repro/obs/slo.py`` (stdlib only).

The serving tier emits raw counters (submitted, shed, expired) and a
latency histogram; an *SLO* turns them into one question — "are we
spending error budget faster than we can afford?" — using the
multi-window multi-burn-rate recipe from the Google SRE workbook:

* **burn rate** = observed error rate / budgeted error rate, so burn 1.0
  exhausts the budget exactly at the SLO period's end and burn 14.4
  exhausts a 30-day 99.9% budget in ~2 days;
* each :class:`BurnWindow` pairs a **long** window (the signal) with a
  **short** window (the reset: the alert clears quickly once the burn
  stops) and fires only when *both* exceed the window's factor — fast
  windows page, slow windows ticket;
* the default ladder is the SRE workbook's fast 5m/1h + slow 6h/3d pair,
  and :func:`scaled_windows` shrinks the whole ladder proportionally so a
  20-second bench run (or a fake-clock test) exercises the identical
  math.

Three SLO kinds cover the stack:

``ratio``
    bad-events / total-events from counter deltas — availability is
    ``1 - (shed + expired) / submitted``.
``latency``
    fraction of requests over a bound from windowed histogram-bucket
    deltas — "p99 under 50 ms" is "no more than 1% of requests above
    50 ms", i.e. objective 0.99 over the 50 ms bucket edge.
``gauge``
    a gauge that *is* a good-fraction (canary per-SNR window accuracy):
    burn = (1 - value) / (1 - objective).

Everything reads from a :class:`~repro_torch.obs.timeseries.TimeSeriesRecorder`
— the engine never touches live registries, so evaluation is cheap,
deterministic under a fake clock, and works identically on fleet-merged
series.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.timeseries import Series, TimeSeriesRecorder

__all__ = ["SLO", "BurnWindow", "SLOStatus", "BurnRateEngine",
           "DEFAULT_BURN_WINDOWS", "scaled_windows", "parse_slo_spec",
           "default_serve_slos"]


@dataclass(frozen=True)
class BurnWindow:
    """One (long, short) window pair with its firing factor."""
    severity: str          # "page" | "ticket"
    long_s: float
    short_s: float
    factor: float          # fire when both windows burn faster than this


#: Google-SRE ladder for a 30-day budget: the fast pair (5m/1h) pages at
#: burn 14.4 (2% of budget per hour), the slow pair (6h/3d) files a
#: ticket at burn 1 (budget exactly on track to exhaust).
DEFAULT_BURN_WINDOWS: Tuple[BurnWindow, ...] = (
    BurnWindow("page", long_s=3600.0, short_s=300.0, factor=14.4),
    BurnWindow("ticket", long_s=3 * 86400.0, short_s=6 * 3600.0,
               factor=1.0),
)


def scaled_windows(scale: float,
                   windows: Sequence[BurnWindow] = DEFAULT_BURN_WINDOWS,
                   ) -> Tuple[BurnWindow, ...]:
    """Shrink every window by ``scale`` (factors unchanged) so short
    runs/tests exercise the production math at bench timescales."""
    if scale <= 0:
        raise ValueError(f"scale must be > 0, got {scale}")
    return tuple(
        BurnWindow(w.severity, w.long_s * scale, w.short_s * scale, w.factor)
        for w in windows)


@dataclass(frozen=True)
class SLO:
    """One declarative objective over recorded series.

    ``kind`` selects the error-rate computation (see module docstring);
    label filters select the child series (first match wins when empty).
    """
    name: str
    kind: str                               # "ratio" | "latency" | "gauge"
    objective: float                        # good fraction in (0, 1)
    # ratio:
    total_metric: str = ""
    bad_metrics: Tuple[str, ...] = ()
    # latency:
    latency_metric: str = ""
    bound_s: float = 0.0
    # gauge:
    gauge_metric: str = ""
    labels: Tuple[Tuple[str, str], ...] = ()

    def __post_init__(self):
        if self.kind not in ("ratio", "latency", "gauge"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not (0.0 < self.objective < 1.0):
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}")
        if self.kind == "ratio" and not (self.total_metric
                                         and self.bad_metrics):
            raise ValueError("ratio SLO needs total_metric + bad_metrics")
        if self.kind == "latency" and not (self.latency_metric
                                           and self.bound_s > 0):
            raise ValueError("latency SLO needs latency_metric + bound_s")
        if self.kind == "gauge" and not self.gauge_metric:
            raise ValueError("gauge SLO needs gauge_metric")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective


@dataclass
class SLOStatus:
    """Evaluation result for one SLO at one instant."""
    slo: SLO
    t: float
    # burn rate per window severity: {"page": (long, short), ...}
    burns: Dict[str, Tuple[Optional[float], Optional[float]]] = \
        field(default_factory=dict)
    firing: List[str] = field(default_factory=list)   # severities firing

    @property
    def ok(self) -> bool:
        return not self.firing

    def to_dict(self) -> Dict:
        return {
            "slo": self.slo.name,
            "kind": self.slo.kind,
            "objective": self.slo.objective,
            "t": self.t,
            "burns": {sev: [b for b in pair] for sev, pair in
                      self.burns.items()},
            "firing": list(self.firing),
        }


def _match(series: List[Series], name: str,
           labels: Tuple[Tuple[str, str], ...]) -> List[Series]:
    want = dict(labels)
    out = []
    for s in series:
        if s.name != name:
            continue
        have = dict(s.labels)
        if all(have.get(k) == v for k, v in want.items()):
            out.append(s)
    return out


class BurnRateEngine:
    """Evaluates SLOs against a recorder's series at each call.

    The clock is the *recorder's* clock — under a fake clock the engine
    asks windows relative to the newest sample, so tests can hand-drive
    time. ``evaluate`` is pure read: the status list is the only output,
    alerting lives in :mod:`repro_torch.obs.anomaly`.
    """

    def __init__(self, recorder: TimeSeriesRecorder, slos: Sequence[SLO],
                 windows: Sequence[BurnWindow] = DEFAULT_BURN_WINDOWS):
        self.recorder = recorder
        self.slos = list(slos)
        self.windows = list(windows)

    # -- per-kind error rates over one trailing window -----------------------

    def _error_rate(self, slo: SLO, window_s: float,
                    now: Optional[float]) -> Optional[float]:
        series = self.recorder.series()
        if slo.kind == "ratio":
            totals = _match(series, slo.total_metric, slo.labels)
            if not totals:
                return None
            total = sum(s.delta(window_s, now) for s in totals)
            if total <= 0:
                return None
            bad = 0.0
            for metric in slo.bad_metrics:
                bad += sum(s.delta(window_s, now)
                           for s in _match(series, metric, slo.labels))
            return min(1.0, bad / total)
        if slo.kind == "latency":
            hists = _match(series, slo.latency_metric, slo.labels)
            fracs = []
            weights = []
            for s in hists:
                d = s._hist_delta(window_s, now)
                if d is None or d[2] <= 0:
                    continue
                frac = s.fraction_over(slo.bound_s, window_s, now)
                if frac is not None:
                    fracs.append(frac)
                    weights.append(d[2])
            if not fracs:
                return None
            total_w = sum(weights)
            return sum(f * w for f, w in zip(fracs, weights)) / total_w
        # gauge: average the latest windowed values (value is a good
        # fraction; error rate is its complement)
        gauges = _match(series, slo.gauge_metric, slo.labels)
        vals = []
        for s in gauges:
            w = s.window(window_s, now)
            if w:
                vals.append(sum(float(v) for _, v in w) / len(w))
        if not vals:
            return None
        return max(0.0, 1.0 - sum(vals) / len(vals))

    def burn_rate(self, slo: SLO, window_s: float,
                  now: Optional[float] = None) -> Optional[float]:
        """Observed error rate over the window divided by the budget."""
        err = self._error_rate(slo, window_s, now)
        if err is None:
            return None
        return err / slo.budget

    def evaluate(self, now: Optional[float] = None) -> List[SLOStatus]:
        t = self.recorder._clock() if now is None else now
        out = []
        for slo in self.slos:
            status = SLOStatus(slo=slo, t=t)
            for w in self.windows:
                b_long = self.burn_rate(slo, w.long_s, now)
                b_short = self.burn_rate(slo, w.short_s, now)
                status.burns[w.severity] = (b_long, b_short)
                if (b_long is not None and b_short is not None
                        and b_long > w.factor and b_short > w.factor):
                    status.firing.append(w.severity)
            out.append(status)
        return out


# -- CLI spec parsing (launch/serve.py --slo) --------------------------------

def default_serve_slos(engine: str = "engine") -> List[SLO]:
    """The serving tier's stock SLOs against its own metric names."""
    return [
        SLO(name="availability", kind="ratio", objective=0.999,
            total_metric="repro_fleet_submitted_total",
            bad_metrics=("repro_fleet_shed_total",
                         "repro_serve_expired_total")),
        # 250 ms: comfortably above this tier's healthy CPU-host
        # micro-batch queueing latency (p95 ~60 ms at batch 8) while far
        # below the shed/overload regime the fleet bench measures (~800 ms)
        SLO(name="latency", kind="latency", objective=0.99,
            latency_metric="repro_serve_request_latency_seconds",
            bound_s=0.250),
    ]


def parse_slo_spec(spec: str) -> List[SLO]:
    """Parse ``--slo`` CLI specs into SLO objects.

    Comma-separated clauses; each is ``name=value[@objective]``:

    * ``availability=0.999`` — ratio SLO over fleet shed+expired vs
      submitted with the given objective;
    * ``p99_ms=50`` or ``p99_ms=50@0.99`` — latency SLO: at most
      (1-objective) of requests above 50 ms (objective defaults 0.99);
    * ``accuracy=0.9`` or ``accuracy=0.9@0.95`` — gauge SLO over the
      canary per-SNR window-accuracy gauge, firing when accuracy sits
      below the target (value acts as the good fraction).
    * ``default`` — shorthand for the stock serving pair.
    """
    slos: List[SLO] = []
    for clause in [c.strip() for c in spec.split(",") if c.strip()]:
        if clause == "default":
            slos.extend(default_serve_slos())
            continue
        if "=" not in clause:
            raise ValueError(f"bad --slo clause {clause!r} (want name=value)")
        name, rhs = clause.split("=", 1)
        name = name.strip()
        if "@" in rhs:
            value_s, obj_s = rhs.split("@", 1)
            objective = float(obj_s)
        else:
            value_s, objective = rhs, None
        value = float(value_s)
        if name == "availability":
            slos.append(SLO(
                name="availability", kind="ratio",
                objective=value if objective is None else objective,
                total_metric="repro_fleet_submitted_total",
                bad_metrics=("repro_fleet_shed_total",
                             "repro_serve_expired_total")))
        elif name == "p99_ms":
            slos.append(SLO(
                name=f"latency_p99_{value:g}ms", kind="latency",
                objective=0.99 if objective is None else objective,
                latency_metric="repro_serve_request_latency_seconds",
                bound_s=value / 1000.0))
        elif name == "accuracy":
            slos.append(SLO(
                name="canary_accuracy", kind="gauge",
                objective=value if objective is None else objective,
                gauge_metric="repro_canary_window_accuracy"))
        else:
            raise ValueError(f"unknown --slo name {name!r} "
                             "(want availability | p99_ms | accuracy)")
    if not slos:
        raise ValueError(f"--slo spec {spec!r} parsed to no SLOs")
    return slos
