"""Bounded time-series recording over a metrics registry (analysis plane).

A copy of the reference's ``repro/obs/timeseries.py`` (stdlib only) over
the port's registry.

The registry (:mod:`repro_torch.obs.metrics`) is a point-in-time scrape: it can
say "789930 accumulations so far" but not "effective density fell 30% in
the last minute".  The paper's central claim — throughput and power
tracking *effective* input/weight sparsity — is only verifiable over
time, and so is every question the alerting layer asks (burn rates,
drift, canary trends).  A :class:`TimeSeriesRecorder` closes that gap:

* it sweeps any registry's families at a fixed interval on a daemon
  thread (or deterministically via :meth:`sample` — what the tests and
  the burn-rate fixtures drive with a fake clock);
* every (family, label-set) child becomes one :class:`Series` holding a
  bounded ring of ``(t, value)`` points with **monotonic timestamps**
  (a sweep whose clock did not advance past the previous sweep is
  dropped, never recorded out of order);
* counters stay *cumulative* in the ring — :meth:`Series.rate` and
  :meth:`Series.delta` derive rates/windows on read, clamping the
  negative deltas a registry swap would produce to zero;
* histogram children record the full cumulative bucket vector per
  sample, so a windowed quantile (:meth:`Series.quantile_over`) or an
  over-bound fraction (:meth:`Series.fraction_over`) is computable for
  any trailing window — the latency-SLO primitive;
* ``registry`` may be a callable returning a registry, so fleet-merged
  sampling is one lambda:
  ``TimeSeriesRecorder(lambda: MetricsRegistry.merged(parts))``;
* :meth:`to_json` exports the whole store (the ``/timeseries`` endpoint
  body).

Cost model: one sweep is a lock-guarded copy of each family's children
plus one float append per series.
"""
from __future__ import annotations

import bisect
import collections
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.obs.metrics import MetricsRegistry, default_registry

__all__ = ["Series", "TimeSeriesRecorder", "set_default_recorder",
           "get_default_recorder"]

#: Histogram sample payload: (cumulative bucket counts incl. +Inf, sum,
#: count).  Stored whole so windowed quantiles need no extra bookkeeping.
HistPoint = Tuple[Tuple[float, ...], float, float]


class Series:
    """One (metric, label-set) ring of ``(t, value)`` samples.

    ``kind`` follows the source family (``counter``/``gauge``/
    ``histogram``); histogram values are :data:`HistPoint` tuples, the
    scalar kinds plain floats.  Appends keep timestamps strictly
    monotonic.  All reads copy under the lock, so a sampler thread and a
    reader (the SLO engine, the HTTP endpoint) never race.
    """

    __slots__ = ("name", "labels", "kind", "buckets", "_lock", "_ring")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 kind: str, capacity: int,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self.labels = labels
        self.kind = kind
        self.buckets = buckets
        self._lock = threading.Lock()
        self._ring: "collections.deque[Tuple[float, Any]]" = \
            collections.deque(maxlen=capacity)

    def append(self, t: float, value) -> bool:
        with self._lock:
            if self._ring and t <= self._ring[-1][0]:
                return False      # monotonic timestamps only
            self._ring.append((t, value))
            return True

    def points(self) -> List[Tuple[float, Any]]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def latest(self) -> Optional[Tuple[float, Any]]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    # -- windowed reads ------------------------------------------------------

    def _at_or_before(self, t: float) -> Optional[Tuple[float, Any]]:
        """Latest point with timestamp <= t (None before the first)."""
        pts = self.points()
        i = bisect.bisect_right([p[0] for p in pts], t)
        return pts[i - 1] if i else None

    def window(self, window_s: float,
               now: Optional[float] = None) -> List[Tuple[float, Any]]:
        """Points in the trailing ``window_s`` seconds ending at ``now``
        (default: the newest sample), *plus* the last point before the
        window so deltas across its left edge are computable."""
        pts = self.points()
        if not pts:
            return []
        t1 = pts[-1][0] if now is None else now
        t0 = t1 - window_s
        ts = [p[0] for p in pts]
        i = bisect.bisect_left(ts, t0)
        # a sample exactly on the edge anchors the delta itself; only
        # step back when the first in-window point is strictly after t0
        lo = i if i < len(ts) and ts[i] == t0 else max(0, i - 1)
        hi = bisect.bisect_right(ts, t1)
        return pts[lo:hi]

    def delta(self, window_s: float, now: Optional[float] = None) -> float:
        """Cumulative-counter increase over the trailing window (>= 0)."""
        w = self.window(window_s, now)
        if len(w) < 2:
            return 0.0
        return max(0.0, float(w[-1][1]) - float(w[0][1]))

    def rate(self, window_s: float, now: Optional[float] = None) -> float:
        """Counter increase per second over the trailing window."""
        w = self.window(window_s, now)
        if len(w) < 2:
            return 0.0
        dt = w[-1][0] - w[0][0]
        if dt <= 0:
            return 0.0
        return max(0.0, float(w[-1][1]) - float(w[0][1])) / dt

    def rates(self) -> List[Tuple[float, float]]:
        """Per-interval counter rates between consecutive samples."""
        pts = self.points()
        out = []
        for (t0, v0), (t1, v1) in zip(pts, pts[1:]):
            dt = t1 - t0
            if dt > 0:
                out.append((t1, max(0.0, float(v1) - float(v0)) / dt))
        return out

    def values(self) -> List[float]:
        """Scalar sample values, oldest first (gauge/counter kinds)."""
        return [float(v) for _, v in self.points()]

    # -- histogram-window primitives (the latency-SLO math) ------------------

    def _hist_delta(self, window_s: float,
                    now: Optional[float] = None) -> Optional[HistPoint]:
        """Bucket/sum/count increase over the trailing window."""
        if self.kind != "histogram":
            raise ValueError(f"{self.name} is a {self.kind}, not histogram")
        w = self.window(window_s, now)
        if not w:
            return None
        if len(w) == 1:   # whole history inside the window: delta from zero
            counts1, sum1, count1 = w[0][1]
            return counts1, sum1, count1
        counts0, sum0, count0 = w[0][1]
        counts1, sum1, count1 = w[-1][1]
        counts = tuple(max(0.0, b - a) for a, b in zip(counts0, counts1))
        return counts, max(0.0, sum1 - sum0), max(0.0, count1 - count0)

    def fraction_over(self, bound: float, window_s: float,
                      now: Optional[float] = None) -> Optional[float]:
        """Fraction of windowed observations above ``bound`` seconds.

        ``bound`` snaps to the nearest bucket boundary >= it (cumulative
        buckets can only answer at their own edges); None when the window
        saw no observations.
        """
        d = self._hist_delta(window_s, now)
        if d is None or d[2] <= 0:
            return None
        counts, _, count = d
        bounds = (self.buckets or ()) + (float("inf"),)
        i = bisect.bisect_left(list(self.buckets or ()), float(bound))
        under = sum(counts[: i + 1])
        del bounds
        return max(0.0, 1.0 - under / count)

    def quantile_over(self, q: float, window_s: float,
                      now: Optional[float] = None) -> Optional[float]:
        """Windowed quantile estimate by linear interpolation in-bucket."""
        d = self._hist_delta(window_s, now)
        if d is None or d[2] <= 0:
            return None
        counts, _, count = d
        bounds = list(self.buckets or ()) + [float("inf")]
        target = q * count
        cum = 0.0
        for i, n in enumerate(counts):
            prev_cum, cum = cum, cum + n
            if cum >= target and n > 0:
                lo = bounds[i - 1] if i else 0.0
                hi = bounds[i]
                if hi == float("inf"):
                    return lo  # unbounded bucket: best defensible answer
                return lo + (hi - lo) * (target - prev_cum) / n
        return bounds[-2] if len(bounds) > 1 else 0.0

    def to_dict(self) -> Dict[str, Any]:
        pts = self.points()
        if self.kind == "histogram":
            points = [[t, {"buckets": list(v[0]), "sum": v[1],
                           "count": v[2]}] for t, v in pts]
        else:
            points = [[t, float(v)] for t, v in pts]
        return {"name": self.name, "labels": dict(self.labels),
                "kind": self.kind, "points": points}


def _series_key(name: str, labelnames: Sequence[str],
                labelvalues: Sequence[str]) -> Tuple:
    return (name,) + tuple(zip(labelnames, labelvalues))


class TimeSeriesRecorder:
    """Periodic sampler turning a registry into bounded time series.

    ``registry`` is a :class:`MetricsRegistry` or a zero-arg callable
    returning one (resolved per sweep — fleet-merged sampling passes
    ``lambda: MetricsRegistry.merged(parts)``); None samples the
    process-wide default registry *live* (a ``set_default_registry``
    swap is picked up on the next sweep).
    """

    def __init__(
        self,
        registry: Union[MetricsRegistry, Callable[[], MetricsRegistry],
                        None] = None,
        *,
        interval_s: float = 1.0,
        capacity: int = 512,
        clock: Callable[[], float] = time.monotonic,
    ):
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self._registry = registry
        self.interval_s = interval_s
        self.capacity = capacity
        self._clock = clock
        self._lock = threading.Lock()
        self._series: Dict[Tuple, Series] = {}
        self._sorted: Optional[List[Series]] = None  # series() cache
        self.n_sweeps = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def _resolve(self) -> MetricsRegistry:
        reg = self._registry
        if reg is None:
            return default_registry()
        if callable(reg):
            return reg()
        return reg

    # -- sampling ------------------------------------------------------------

    def sample(self, t: Optional[float] = None) -> int:
        """One sweep over the registry; returns points appended.

        Safe against concurrent registry mutation: ``families()`` /
        ``items()`` snapshot under the registry locks, and a family or
        child appearing mid-sweep simply starts its series on the next
        sweep it is seen in.
        """
        now = self._clock() if t is None else float(t)
        reg = self._resolve()
        appended = 0
        for fam in reg.families():
            for key, child in fam.items():
                skey = _series_key(fam.name, fam.labelnames, key)
                with self._lock:
                    series = self._series.get(skey)
                    if series is None:
                        series = self._series[skey] = Series(
                            fam.name, tuple(zip(fam.labelnames, key)),
                            fam.kind, self.capacity, buckets=fam.buckets)
                        self._sorted = None  # invalidate series() cache
                if fam.kind == "histogram":
                    with fam._lock:
                        value: Any = (tuple(float(c) for c in child.counts),
                                      float(child.sum), float(child.count))
                else:
                    value = float(child.value)
                if series.append(now, value):
                    appended += 1
        with self._lock:
            self.n_sweeps += 1
        return appended

    # -- lookup / export -----------------------------------------------------

    def series(self) -> List[Series]:
        # sorted once per series-set change, not per read: the burn-rate
        # engine reads this several times per evaluation tick
        with self._lock:
            if self._sorted is None:
                self._sorted = [self._series[k]
                                for k in sorted(self._series, key=repr)]
            return list(self._sorted)

    def get(self, name: str, **labels) -> Optional[Series]:
        fam_labels = tuple(sorted(labels.items()))
        with self._lock:
            for (sname, *skv), series in self._series.items():
                if sname == name and tuple(sorted(skv)) == fam_labels:
                    return series
        return None

    def to_json(self) -> Dict[str, Any]:
        return {
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            "n_sweeps": self.n_sweeps,
            "series": [s.to_dict() for s in self.series()],
        }

    # -- background loop -----------------------------------------------------

    def start(self) -> "TimeSeriesRecorder":
        if self._thread is not None:
            raise RuntimeError("recorder already started")
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(self.interval_s):
                self.sample()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="obs-timeseries")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "TimeSeriesRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


# -- process-wide recorder (what the /timeseries endpoint serves) ------------

_recorder: Optional[TimeSeriesRecorder] = None
_recorder_lock = threading.Lock()


def set_default_recorder(
        recorder: Optional[TimeSeriesRecorder]
) -> Optional[TimeSeriesRecorder]:
    """Install the process-wide recorder; returns the previous one."""
    global _recorder
    with _recorder_lock:
        old, _recorder = _recorder, recorder
        return old


def get_default_recorder() -> Optional[TimeSeriesRecorder]:
    with _recorder_lock:
        return _recorder
