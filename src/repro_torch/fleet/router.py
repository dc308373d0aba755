"""Front-end fleet router: N replica groups behind one admission door.

Port of the reference's ``repro/fleet/router.py``.  The single-process
:class:`~repro_torch.serve.AsyncAMCServeEngine` tops out at one host's
devices; the fleet tier is the shape that takes "millions of users": a
:class:`FleetRouter` owns N **replica groups** (each a full async engine —
queue, micro-batcher, worker loops, its served step captured in CUDA
graphs on the card) and fronts them with the production serving
primitives the single engine lacks:

* **join-shortest-queue dispatch** — each request goes to the replica
  with the smallest backlog (deterministic index tie-break, no RNG);
* **admission control / load shedding** — a replica whose ``max_queue``
  bound is hit rejects; when *every* replica rejects the request is shed
  with :class:`ShedError` at the door (bounded latency above saturation,
  never an unbounded queue).  An optional ``shed_p99_ms`` threshold sheds
  ``bulk``-class traffic early whenever the fleet's recent p99 breaches
  it, protecting realtime headroom;
* **per-request deadlines and priority classes** — propagated to the
  deadline/priority-aware micro-batcher in every replica (expired
  requests fail fast without occupying a batch slot; realtime dequeues
  ahead of bulk by weighted round-robin);
* **elastic capacity** — ``scale_up()`` builds a replica through the
  engine factory and **replays the deploy lineage** (bound versions,
  primary flip, traffic router) so a replica added mid-canary serves
  exactly what its siblings serve; ``scale_down()`` fences a replica off
  from new traffic, drains its backlog, then closes it — zero dropped
  requests.  The :class:`~repro_torch.fleet.autoscaler.Autoscaler` drives both
  against p99/utilization targets.

The router is **engine-like**: it exposes ``cfg`` / ``versions`` /
``bind_version`` / ``swap_to`` / ``set_router`` / ``version_stats`` /
``batcher`` (a fleet-wide facade), so the whole :mod:`repro_torch.deploy`
toolchain — ``hot_swap``, canary routing, ``CanaryMonitor`` — works on a
fleet exactly as on one engine, with every operation fanned out to all
replicas.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.obs.metrics import default_registry
from repro_torch.obs.trace import begin_trace, tadd, tfinish
from repro_torch.serve.batcher import PRIORITIES, EngineClosed, QueueFull
from repro_torch.serve.engine import ServeStats

__all__ = ["ShedError", "Replica", "FleetRouter", "engine_factory",
           "merge_stats"]


class ShedError(RuntimeError):
    """Request refused at the fleet door (admission control).

    ``reason`` is ``"queue"`` (every replica's backlog bound hit) or
    ``"p99"`` (bulk traffic shed while the fleet p99 breaches the
    configured threshold).
    """

    def __init__(self, message: str, reason: str):
        super().__init__(message)
        self.reason = reason


@dataclasses.dataclass
class Replica:
    """One replica group: a name, its engine, and its birth order.

    ``fenced``/``gate`` implement the retirement fence: ``submit`` checks
    the flag and enqueues while holding ``gate``, and ``scale_down`` sets
    the flag under the same gate before draining — so once the fence is
    up, no request (not even one whose replica-list snapshot predates the
    retirement) can slip into the replica's queue behind the drain
    barrier.
    """

    name: str
    engine: Any
    index: int
    fenced: bool = False
    gate: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)


def engine_factory(params, cfg, masks=None, *, device=None,
                   **engine_kwargs):
    """Build a ``name -> AsyncAMCServeEngine`` factory over fixed weights.

    The standard way to hand a :class:`FleetRouter` its replica recipe —
    every replica binds the same weights/config with the same serving
    knobs (``max_batch``, ``max_queue``, ``pace_ms``, ``backend`` ...) on
    the same ``device`` (the card unless ``device="cpu"``): replicas share
    one card.
    """
    from repro_torch.serve.engine import AsyncAMCServeEngine

    def make(name: str):
        kw = dict(engine_kwargs)
        # the replica name becomes the {engine=...} label on every serve
        # metric, keeping fleet-wide aggregates separable per replica
        kw.setdefault("name", name)
        return AsyncAMCServeEngine(params, cfg, masks=masks, device=device,
                                   **kw)

    return make


def _fair_recent(parts: List[List[float]], cap: int) -> List[float]:
    """Concatenate sample windows, trimming *each part's* oldest samples.

    When the combined history exceeds ``cap``, every part contributes its
    most recent ``cap // n_parts`` samples.  Sequential concatenate-then-
    trim would instead keep whichever replicas happened to be appended
    last — with full windows, the merged percentiles would be computed
    over the *final replica only*, silently dropping every other
    replica's tail latencies (the bug pinned by
    ``test_merge_stats_fair_window`` in ``tests/test_fleet.py``).
    """
    total = sum(len(x) for x in parts)
    if total > cap and len(parts) > 1:
        share = max(1, cap // len(parts))
        parts = [x[-share:] for x in parts]
    out: List[float] = []
    for x in parts:
        out.extend(x)
    return out[-cap:]


def merge_stats(parts: List[ServeStats], backend: str = "") -> ServeStats:
    """Aggregate per-replica :class:`ServeStats` into one fleet view.

    Counters add exactly; latency / queue-depth histories concatenate,
    and when the combined history exceeds the class window every replica
    contributes an equal share of its most recent samples (so merged
    percentiles represent the whole fleet, not the last-merged replica);
    ``wall_s`` takes the widest serving window so fleet throughput is
    conservative, never inflated by summing overlapping windows.
    """
    merged = ServeStats(backend=backend)
    for p in parts:
        if not merged.backend:
            merged.backend = p.backend
        merged.frame_len = p.frame_len
        merged.requests += p.requests
        merged.batches += p.batches
        merged.accumulations += p.accumulations
        merged.fetched_bits += p.fetched_bits
        merged.padded_frames += p.padded_frames
        merged.short_holds += p.short_holds
        merged.wall_s = max(merged.wall_s, p.wall_s)
        for b, n in p.backend_batch_counts().items():
            merged.backend_batch_totals[b] = (
                merged.backend_batch_totals.get(b, 0) + n)
    merged.latencies_s = _fair_recent(
        [list(p.latencies_s) for p in parts], ServeStats.MAX_SAMPLES)
    merged.queue_depths = [int(d) for d in _fair_recent(
        [list(p.queue_depths) for p in parts], ServeStats.MAX_SAMPLES)]
    return merged


class _FleetBatcher:
    """Fleet-wide facade over the replicas' batchers.

    Exposes exactly the surface :func:`repro_torch.deploy.swap.hot_swap` (and
    anything else written against ``engine.batcher``) needs: total
    backlog and a drain barrier spanning every replica.
    """

    def __init__(self, fleet: "FleetRouter"):
        self._fleet = fleet

    def qsize(self) -> int:
        return sum(r.engine.batcher.qsize()
                   for r in self._fleet._snapshot())

    def drain_barrier(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else time.perf_counter() + timeout
        ok = True
        for rep in self._fleet._snapshot():
            remaining = None
            if deadline is not None:
                remaining = max(0.0, deadline - time.perf_counter())
            ok = rep.engine.batcher.drain_barrier(timeout=remaining) and ok
        return ok

    @property
    def n_expired(self) -> int:
        return sum(r.engine.batcher.n_expired for r in self._fleet._snapshot())

    @property
    def n_rejected(self) -> int:
        return sum(r.engine.batcher.n_rejected
                   for r in self._fleet._snapshot())


class FleetRouter:
    """Admission-controlled router over elastic replica groups.

    ``factory`` is a ``name -> AsyncAMCServeEngine`` callable (see
    :func:`engine_factory`).  ``replicas`` engines are built eagerly;
    ``scale_up``/``scale_down`` move the count within
    ``[min_replicas, max_replicas]``.
    """

    def __init__(
        self,
        factory: Callable[[str], Any],
        *,
        replicas: int = 1,
        min_replicas: int = 1,
        max_replicas: int = 8,
        default_priority: str = "realtime",
        default_deadline_ms: Optional[float] = None,
        shed_p99_ms: Optional[float] = None,
        p99_window: int = 256,
        clock=time.perf_counter,
    ):
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}")
        if not min_replicas <= replicas <= max_replicas:
            raise ValueError(
                f"replicas={replicas} outside [{min_replicas}, "
                f"{max_replicas}]")
        if default_priority not in PRIORITIES:
            raise ValueError(f"unknown priority {default_priority!r}")
        self._factory = factory
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.default_priority = default_priority
        self.default_deadline_ms = default_deadline_ms
        self.shed_p99_ms = shed_p99_ms
        self.p99_window = p99_window
        self._clock = clock
        # _lock guards the replica list and counters (short critical
        # sections on the submit path); _scale_lock serializes the slow
        # lifecycle operations (replica builds, fleet-wide binds/flips)
        # without ever blocking admission
        self._lock = threading.Lock()
        self._scale_lock = threading.Lock()
        self._replicas: List[Replica] = []
        self._retired: List[Replica] = []
        self._next_index = 0
        # deploy lineage, replayed onto every scale-up replica so late
        # joiners serve the same versions/routing as their siblings
        self._bound: "OrderedDict[str, dict]" = OrderedDict()
        self._primary: Optional[str] = None
        self._shared_router: Optional[Callable[[], str]] = None
        # door-level counters (per shed reason and priority class)
        self.n_shed = 0
        self.shed_by_reason: Dict[str, int] = {"queue": 0, "p99": 0}
        self.shed_by_priority: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self.n_submitted = 0
        # registry mirrors of the door-level counters
        reg = default_registry()
        self._m_submitted = reg.counter(
            "repro_fleet_submitted_total",
            "Requests admitted through the fleet door")
        self._m_shed = reg.counter(
            "repro_fleet_shed_total",
            "Requests refused by fleet admission control",
            ("reason", "priority"))
        self._m_replicas = reg.gauge(
            "repro_fleet_replicas", "Live replica count")
        self.batcher = _FleetBatcher(self)
        for _ in range(replicas):
            rep = self._build_replica()
            with self._lock:
                self._replicas.append(rep)
        self._primary = self._replicas[0].engine.active_version
        self._m_replicas.set(self.n_replicas)

    # -- replica lifecycle --------------------------------------------------

    def _snapshot(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas)

    def _build_replica(self) -> Replica:
        with self._lock:
            index = self._next_index
            self._next_index += 1
            bound = [(label, dict(spec)) for label, spec in self._bound.items()]
            primary = self._primary
            router = self._shared_router
        name = f"replica-{index}"
        engine = self._factory(name)
        # replay the deploy lineage: a replica born mid-canary must serve
        # the same version table, primary, and traffic split as the rest
        for label, spec in bound:
            engine.bind_version(label, **spec)
        if primary is not None and primary != engine.active_version:
            engine.swap_to(primary)
        if router is not None:
            engine.set_router(router)
        return Replica(name=name, engine=engine, index=index)

    @property
    def n_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    def replica_names(self) -> List[str]:
        return [r.name for r in self._snapshot()]

    def scale_up(self) -> Optional[str]:
        """Add one replica (replaying the deploy lineage); None at max.

        The engine build/compile runs outside the admission lock — the
        fleet keeps serving while the new replica warms up, and it only
        joins the routing set once fully bound.
        """
        with self._scale_lock:
            if self.n_replicas >= self.max_replicas:
                return None
            rep = self._build_replica()
            with self._lock:
                self._replicas.append(rep)
            self._m_replicas.set(self.n_replicas)
            return rep.name

    def scale_down(self, drain_timeout: float = 30.0) -> Optional[str]:
        """Retire the youngest replica; None at min.

        The replica is fenced off from new traffic first, its backlog is
        drained (every queued request still gets served), and only then
        is its engine closed — scale-down never drops a request.
        """
        with self._scale_lock:
            with self._lock:
                if len(self._replicas) <= self.min_replicas:
                    return None
                rep = self._replicas.pop()  # youngest: cheapest to retire
            # fence: a concurrent submit that snapshotted the replica list
            # before the pop could still enqueue here.  Submits check
            # ``fenced`` and enqueue under ``rep.gate``, so acquiring the
            # gate to raise the flag (a) waits out any submit that already
            # passed the check — its request lands before the barrier's
            # seq snapshot — and (b) guarantees later submits skip this
            # replica.  Only then is the drain target captured.
            with rep.gate:
                rep.fenced = True
            rep.engine.batcher.drain_barrier(timeout=drain_timeout)
            rep.engine.close()
            with self._lock:
                self._retired.append(rep)
            self._m_replicas.set(self.n_replicas)
            return rep.name

    # -- admission / dispatch -----------------------------------------------

    def _shed(self, reason: str, priority: str, detail: str,
              trace=None) -> "ShedError":
        with self._lock:
            self.n_shed += 1
            self.shed_by_reason[reason] = (
                self.shed_by_reason.get(reason, 0) + 1)
            self.shed_by_priority[priority] = (
                self.shed_by_priority.get(priority, 0) + 1)
        self._m_shed.labels(reason=reason, priority=priority).inc()
        tadd(trace, "shed", reason=reason, priority=priority)
        tfinish(trace)
        return ShedError(detail, reason=reason)

    def submit(self, iq: np.ndarray, *, priority: Optional[str] = None,
               deadline_ms: Optional[float] = None):
        """Admit one frame into the least-loaded replica; a future.

        Raises :class:`ShedError` when admission control refuses the
        request (every replica queue full, or bulk traffic during a p99
        breach) — fail fast at the door, never queue unboundedly.
        """
        priority = self.default_priority if priority is None else priority
        if priority not in PRIORITIES:
            raise ValueError(f"unknown priority {priority!r}")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        # the fleet door originates the request trace: replica attempts,
        # shed decisions and the queue transit all land on one timeline
        trace = begin_trace()
        tadd(trace, "submit", priority=priority)
        if (self.shed_p99_ms is not None and priority == "bulk"
                and self.recent_p99_ms() > self.shed_p99_ms):
            raise self._shed(
                "p99", priority,
                f"bulk traffic shed: fleet p99 above {self.shed_p99_ms}ms",
                trace=trace)
        reps = self._snapshot()
        if not reps:
            raise RuntimeError("fleet has no replicas")
        # join-shortest-queue, deterministic index tie-break; on a full
        # replica fall through to the next-shortest before shedding
        order = sorted(reps, key=lambda r: (r.engine.batcher.qsize(),
                                            r.index))
        for rep in order:
            # check-and-enqueue under the replica's retirement gate: once
            # scale_down raises the fence, no submit — even one holding a
            # pre-retirement list snapshot — can land a request behind the
            # drain barrier.  EngineClosed (a fleet close racing this
            # snapshot) likewise skips to the next candidate; any other
            # error is a real engine fault and propagates.
            with rep.gate:
                if rep.fenced:
                    continue
                # optimistic: recorded before the enqueue so the timeline
                # stays ordered; a refusal appends replica-full after it
                tadd(trace, "admit", replica=rep.name)
                try:
                    fut = rep.engine.submit(iq, deadline_ms=deadline_ms,
                                            priority=priority, trace=trace)
                except (QueueFull, EngineClosed) as e:
                    tadd(trace, "replica-full", replica=rep.name,
                         reason=type(e).__name__)
                    continue
            with self._lock:
                self.n_submitted += 1
            self._m_submitted.inc()
            return fut
        raise self._shed("queue", priority,
                         "all replica queues at their admission bound",
                         trace=trace)

    def classify(self, iq: np.ndarray, timeout: float = 300.0, *,
                 priority: Optional[str] = None,
                 deadline_ms: Optional[float] = None) -> np.ndarray:
        """Blocking convenience wrapper: (N, 2, L) -> class ids (N,).

        Mirrors the engine's: on timeout/failure the outstanding futures
        are cancelled (never leaked into replica queues) before the error
        propagates.
        """
        futures = [self.submit(iq[i], priority=priority,
                               deadline_ms=deadline_ms)
                   for i in range(iq.shape[0])]
        out = np.empty((len(futures),), dtype=np.int32)
        try:
            for i, f in enumerate(futures):
                out[i] = f.result(timeout=timeout)
        except BaseException:
            for f in futures:
                f.cancel()
            raise
        return out

    # -- control-plane signals ----------------------------------------------

    def recent_p99_ms(self, window: Optional[int] = None) -> float:
        """p99 (ms) over the most recent served latencies, fleet-wide."""
        window = self.p99_window if window is None else window
        lat: List[float] = []
        for rep in self._snapshot():
            lat.extend(rep.engine.recent_latencies(window))
        if not lat:
            return 0.0
        return float(np.percentile(lat, 99.0)) * 1e3

    def queue_depth(self) -> int:
        return self.batcher.qsize()

    def signals(self) -> Dict[str, Any]:
        """One control-plane sample: what the autoscaler (and bench) read.

        Cumulative counters (``busy_s``, ``held_busy_s``, ``shed``,
        ``expired``, ``requests``) are meant to be differenced between
        ticks; ``p99_ms`` and ``queue_depth`` are instantaneous.
        """
        reps = self._snapshot()
        with self._lock:
            shed = self.n_shed
            shed_by_reason = dict(self.shed_by_reason)
        return {
            "t": self._clock(),
            "n_replicas": len(reps),
            "queue_depth": sum(r.engine.batcher.qsize() for r in reps),
            "p99_ms": self.recent_p99_ms(),
            "requests": sum(r.engine.stats.requests for r in reps),
            "busy_s": sum(r.engine.busy_s for r in reps),
            "held_busy_s": sum(r.engine.held_busy_s for r in reps),
            "workers": sum(r.engine.n_workers for r in reps),
            "shed": shed,
            "shed_by_reason": shed_by_reason,
            "expired": sum(r.engine.batcher.n_expired for r in reps),
            "rejected": sum(r.engine.batcher.n_rejected for r in reps),
        }

    def export_stats(self) -> Dict[str, Any]:
        """Fleet digest + per-replica breakdown (JSON-ready)."""
        reps = self._snapshot()
        with self._lock:
            retired = list(self._retired)
        return {
            "n_replicas": len(reps),
            "replicas": {r.name: r.engine.export_stats() for r in reps},
            "retired": [r.name for r in retired],
            "fleet": self.stats.summary(),
            "n_submitted": self.n_submitted,
            "n_shed": self.n_shed,
            "shed_by_reason": dict(self.shed_by_reason),
            "shed_by_priority": dict(self.shed_by_priority),
            "n_expired": self.batcher.n_expired,
        }

    @property
    def stats(self) -> ServeStats:
        """Merged fleet-wide ServeStats (live + retired replicas)."""
        with self._lock:
            engines = [r.engine for r in self._replicas + self._retired]
        return merge_stats([e.stats for e in engines])

    # -- engine-like deploy surface (hot_swap / canary / monitor) -----------

    @property
    def cfg(self):
        return self._snapshot()[0].engine.cfg

    @property
    def active_version(self) -> str:
        with self._lock:
            primary = self._primary
        return primary if primary is not None else \
            self._snapshot()[0].engine.active_version

    def versions(self) -> Dict[str, Any]:
        return self._snapshot()[0].engine.versions()

    def get_version(self, label: str):
        return self._snapshot()[0].engine.get_version(label)

    def bind_version(self, label: str, params, masks=None, **kwargs):
        """Bind a version on *every* replica; recorded for scale-up replay."""
        spec = dict(params=params, masks=masks, **kwargs)
        with self._scale_lock:
            ver = None
            for rep in self._snapshot():
                ver = rep.engine.bind_version(label, **spec)
            with self._lock:
                self._bound[label] = spec
            return ver

    def swap_to(self, label: str) -> str:
        """Flip the primary on every replica; returns the old label."""
        with self._scale_lock:
            old = self.active_version
            for rep in self._snapshot():
                rep.engine.swap_to(label)
            with self._lock:
                self._primary = label
            return old

    def remove_version(self, label: str) -> None:
        with self._scale_lock:
            for rep in self._snapshot():
                rep.engine.remove_version(label)
            with self._lock:
                self._bound.pop(label, None)

    def set_router(self, router: Optional[Callable[[], str]]) -> None:
        """Install one *shared* traffic router across all replicas.

        Sharing a single (thread-safe) router keeps the canary split
        globally proportional — each replica's worker draws from the same
        smooth-weighted-round-robin sequence.
        """
        with self._scale_lock:
            with self._lock:
                self._shared_router = router
            for rep in self._snapshot():
                rep.engine.set_router(router)

    def version_stats(self) -> Dict[str, ServeStats]:
        """Per-label stats merged across replicas (monitor-compatible)."""
        with self._lock:
            engines = [r.engine for r in self._replicas + self._retired]
        by_label: Dict[str, List[ServeStats]] = {}
        for eng in engines:
            for label, st in eng.version_stats().items():
                by_label.setdefault(label, []).append(st)
        return {label: merge_stats(parts)
                for label, parts in by_label.items()}

    # -- readiness / shutdown -----------------------------------------------

    def is_ready(self) -> bool:
        """True once every live replica is ready (its warm-up or first
        step done, see ``AsyncAMCServeEngine.is_ready``)."""
        reps = self._snapshot()
        return bool(reps) and all(rep.engine.is_ready() for rep in reps)

    @property
    def closed(self) -> bool:
        with self._lock:
            return not self._replicas and bool(self._retired)

    def close(self) -> None:
        """Close every replica; every queued future resolves (or fails)."""
        with self._scale_lock:
            with self._lock:
                reps = list(self._replicas)
                self._replicas = []
                self._retired.extend(reps)
            for rep in reps:       # fence first: a submit racing shutdown
                with rep.gate:     # sheds at the door instead of landing
                    rep.fenced = True  # a request the close will fail
            for rep in reps:
                rep.engine.close()
            self._m_replicas.set(0)

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
