"""Process-wide metrics registry: counters, gauges, histograms with labels.

A copy of the reference's ``repro/obs/metrics.py`` (numpy-free, no jax):
the same families, label rules and exposition text, so a scrape of the
port's engine reads like one of the reference's.

One shared taxonomy for every tier (serve -> fleet -> deploy) instead of
per-subsystem ad-hoc counters.  The design is deliberately the Prometheus
client model, minus the dependency:

* a :class:`MetricsRegistry` holds **families** (one metric name + type +
  help + label names); ``family.labels(engine="r0")`` resolves a **child**
  (one label-value combination) with ``inc`` / ``set`` / ``observe``;
* children are cached, so the hot path resolves its labels once at
  construction and pays one guarded float add per event afterwards —
  instrumentation must never become the thing it measures;
* :meth:`MetricsRegistry.to_prometheus` writes text exposition format
  0.0.4 (one scrape body for a ``/metrics`` endpoint);
  :meth:`MetricsRegistry.snapshot` is the JSON form;
* :meth:`MetricsRegistry.merged` adds registries together — the fleet
  aggregation primitive (counters/histograms add; gauges add too, which
  is only meaningful when per-replica gauges carry a replica label — the
  convention every gauge in this repo follows).

Naming scheme (see README "Observability"): every metric is prefixed
``repro_``, subsystem second (``serve``/``fleet``/``autoscale``/
``canary``/``deploy``/``activity``/``plan``), unit suffixes follow the
Prometheus convention (``_total`` counters, ``_seconds`` histograms).
"""
from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "MetricsRegistry",
    "default_registry",
    "set_default_registry",
    "DEFAULT_LATENCY_BUCKETS",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: Default histogram buckets (seconds): sub-ms to tens of seconds — spans
#: the serving-step latencies (~ms) and drain/bind walls (~s) in one ladder.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(v: float) -> str:
    """Exposition number format: exact integers stay integral."""
    f = float(v)
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_text(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


class _Counter:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc {amount})")
        with self._lock:
            self.value += amount


class _Gauge:
    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _Histogram:
    __slots__ = ("_lock", "_bounds", "counts", "sum", "count")

    def __init__(self, lock: threading.Lock, bounds: Tuple[float, ...]):
        self._lock = lock
        self._bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # per-bucket, +Inf last
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1


_CHILD_TYPES = {"counter": _Counter, "gauge": _Gauge, "histogram": _Histogram}


class _Family:
    """One metric name: type + help + label names + child per label set."""

    def __init__(self, kind: str, name: str, help: str,
                 labelnames: Tuple[str, ...],
                 buckets: Optional[Tuple[float, ...]] = None):
        self.kind = kind
        self.name = name
        self.help = help
        self.labelnames = labelnames
        self.buckets = buckets
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _make_child(self):
        if self.kind == "histogram":
            return _Histogram(self._lock, self.buckets)
        return _CHILD_TYPES[self.kind](self._lock)

    def labels(self, **labelvalues: str):
        if set(labelvalues) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(sorted(labelvalues))}")
        key = tuple(str(labelvalues[n]) for n in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._make_child()
            return child

    # no-label convenience: the family itself acts as its single child
    def _solo(self):
        if self.labelnames:
            raise ValueError(
                f"{self.name} takes labels {self.labelnames}; call "
                f".labels(...) first")
        return self.labels()

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    def set_exclusive(self, **labelvalues: str) -> None:
        """Gauge-info pattern: set the matching child to 1, all others 0
        (e.g. ``repro_deploy_production_info{version=...} 1``)."""
        if self.kind != "gauge":
            raise ValueError(f"{self.name}: set_exclusive is gauge-only")
        target = self.labels(**labelvalues)
        with self._lock:
            for child in self._children.values():
                child.value = 1.0 if child is target else 0.0

    def items(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return list(self._children.items())


class MetricsRegistry:
    """Thread-safe registry of metric families (see module docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # -- family constructors (idempotent: same spec returns the family) -----

    def _family(self, kind: str, name: str, help: str,
                labelnames: Sequence[str],
                buckets: Optional[Sequence[float]] = None) -> _Family:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        labelnames = tuple(labelnames)
        for ln in labelnames:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        b = None
        if kind == "histogram":
            b = tuple(sorted(float(x) for x in
                             (buckets or DEFAULT_LATENCY_BUCKETS)))
            if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
                raise ValueError(f"{name}: buckets must be strictly "
                                 f"increasing and non-empty, got {b}")
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.labelnames}, requested "
                        f"{kind}{labelnames}")
                return fam
            fam = _Family(kind, name, help, labelnames, buckets=b)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._family("counter", name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._family("gauge", name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> _Family:
        return self._family("histogram", name, help, labelnames,
                            buckets=buckets)

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def value(self, name: str, **labelvalues) -> float:
        """Read one counter/gauge child's current value (0.0 if unseen)."""
        fam = self.get(name)
        if fam is None:
            return 0.0
        key = tuple(str(labelvalues.get(n, "")) for n in fam.labelnames)
        with fam._lock:
            child = fam._children.get(key)
            return float(child.value) if child is not None else 0.0

    # -- exposition ----------------------------------------------------------

    def to_prometheus(self) -> str:
        """Text exposition format 0.0.4 (one scrape body)."""
        out: List[str] = []
        for fam in self.families():
            out.append(f"# HELP {fam.name} {_escape_help(fam.help)}")
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in sorted(fam.items()):
                lt = _labels_text(fam.labelnames, key)
                if fam.kind == "histogram":
                    cum = 0
                    with fam._lock:
                        counts = list(child.counts)
                        hsum, hcount = child.sum, child.count
                    for bound, n in zip(fam.buckets + (float("inf"),),
                                        counts):
                        cum += n
                        le = _labels_text(fam.labelnames + ("le",),
                                          key + (_fmt(bound),))
                        out.append(f"{fam.name}_bucket{le} {cum}")
                    out.append(f"{fam.name}_sum{lt} {_fmt(hsum)}")
                    out.append(f"{fam.name}_count{lt} {hcount}")
                else:
                    out.append(f"{fam.name}{lt} {_fmt(child.value)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """JSON-ready dump (what the fleet ships between processes)."""
        out: Dict[str, dict] = {}
        for fam in self.families():
            series = []
            for key, child in sorted(fam.items()):
                labels = dict(zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    with fam._lock:
                        series.append({
                            "labels": labels,
                            "buckets": {_fmt(b): n for b, n in
                                        zip(fam.buckets + (float("inf"),),
                                            child.counts)},
                            "sum": child.sum, "count": child.count})
                else:
                    series.append({"labels": labels, "value": child.value})
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "labelnames": list(fam.labelnames),
                             "series": series}
        return out

    # -- fleet aggregation ---------------------------------------------------

    @classmethod
    def merged(cls, parts: Iterable["MetricsRegistry"]) -> "MetricsRegistry":
        """Add registries together (fleet aggregation).

        Counters and histograms add exactly.  Gauges add too — correct
        under this repo's convention that per-replica gauges carry a
        replica-identifying label (so same-name children never collide
        across replicas); same-label gauges from different parts sum,
        which a caller aggregating e.g. queue depths actually wants.
        Conflicting family definitions (type / label names) raise.
        """
        merged = cls()
        for part in parts:
            for fam in part.families():
                mfam = merged._family(fam.kind, fam.name, fam.help,
                                      fam.labelnames, buckets=fam.buckets)
                if fam.kind == "histogram" and mfam.buckets != fam.buckets:
                    raise ValueError(
                        f"{fam.name}: bucket ladders differ across parts")
                for key, child in fam.items():
                    dst = mfam.labels(**dict(zip(fam.labelnames, key)))
                    with mfam._lock:
                        if fam.kind == "histogram":
                            for i, n in enumerate(child.counts):
                                dst.counts[i] += n
                            dst.sum += child.sum
                            dst.count += child.count
                        else:
                            dst.value += child.value
        return merged


_default = MetricsRegistry()
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem records into."""
    with _default_lock:
        return _default


def set_default_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry (tests isolate through this);
    returns the previous one."""
    global _default
    with _default_lock:
        old, _default = _default, registry
        return old
