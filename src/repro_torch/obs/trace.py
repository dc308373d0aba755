"""Per-request tracing: lightweight span timelines through the serving path.

One request's life is a sequence of timestamped events::

    submit -> admit -> enqueue -> dequeue -> batch-form
           -> jit-step-start -> jit-step-end -> complete

with the failure terminals ``shed`` (admission refused at the fleet
door), ``reject`` (single-engine queue bound), ``expired`` (deadline
passed while queued), ``cancelled``, and ``error``.  Spans are the gaps
between consecutive events — :meth:`RequestTrace.spans` derives them, so
queueing delay vs batch-forming delay vs step time are separable
per request, fleet-wide.

Cost model: tracing is **off by default** and the hot path pays one
module-global read per request when disabled.  When enabled
(:func:`enable_tracing`), the deterministic ``sample_every`` knob traces
every Nth submission; completed traces land in a bounded ring buffer
(:class:`TraceLog`) whose JSON ``dump()`` is the ``--trace-dump``
artifact.  Traces ride on the request itself (``Request.trace`` /
``ServeFuture.trace``), so no global lookup happens per event — an
untraced request carries ``None`` and every instrumentation site is a
single ``is not None`` check.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = [
    "TraceEvent",
    "RequestTrace",
    "TraceLog",
    "TERMINAL_EVENTS",
    "enable_tracing",
    "disable_tracing",
    "get_tracer",
    "begin_trace",
    "tadd",
    "tfinish",
]

#: Event names that end a request's timeline.
TERMINAL_EVENTS = frozenset(
    {"complete", "expired", "cancelled", "shed", "reject", "error"})


@dataclasses.dataclass
class TraceEvent:
    name: str
    t: float                      # perf_counter timestamp
    attrs: Dict[str, Any]


class RequestTrace:
    """Event timeline of one request (appended to by whoever holds it).

    Events are appended in processing order by the producer thread, the
    batcher consumer, and the worker — which hand the request off through
    a queue, so appends never race.  ``finish`` routes the completed
    trace back to its :class:`TraceLog` (idempotent: losing a
    cancel-vs-complete race records the first terminal only).
    """

    __slots__ = ("request_id", "events", "_log", "_done")

    def __init__(self, request_id: int, log: "TraceLog"):
        self.request_id = request_id
        self.events: List[TraceEvent] = []
        self._log = log
        self._done = False

    def add(self, name: str, t: Optional[float] = None, **attrs) -> None:
        self.events.append(
            TraceEvent(name=name, t=time.perf_counter() if t is None else t,
                       attrs=attrs))

    def finish(self) -> None:
        self._log._finish(self)

    def terminal(self) -> Optional[str]:
        for ev in reversed(self.events):
            if ev.name in TERMINAL_EVENTS:
                return ev.name
        return None

    def spans(self) -> List[Dict[str, Any]]:
        """Gaps between consecutive events: the per-phase latency split."""
        out = []
        for a, b in zip(self.events, self.events[1:]):
            out.append({"from": a.name, "to": b.name,
                        "seconds": b.t - a.t})
        return out

    def to_dict(self) -> Dict[str, Any]:
        t0 = self.events[0].t if self.events else 0.0
        return {
            "request_id": self.request_id,
            "terminal": self.terminal(),
            # t0 anchors the per-event relative times on the shared
            # perf_counter axis so dumps stay orderable across requests
            # (the Perfetto exporter needs this)
            "t0": t0,
            "events": [{"name": ev.name, "t_rel_s": ev.t - t0, **ev.attrs}
                       for ev in self.events],
            "spans": self.spans(),
            "total_s": (self.events[-1].t - t0) if self.events else 0.0,
        }


class TraceLog:
    """Bounded ring buffer of completed traces + the sampling decision.

    ``sample_every=N`` traces every Nth submission (deterministic — no
    RNG, so tests and benches see exactly ``ceil(n/N)`` traces).
    """

    def __init__(self, capacity: int = 2048, sample_every: int = 1):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if sample_every < 1:
            raise ValueError(
                f"sample_every must be >= 1, got {sample_every}")
        self.capacity = capacity
        self.sample_every = sample_every
        self._lock = threading.Lock()
        self._ring: "collections.deque[RequestTrace]" = collections.deque(
            maxlen=capacity)
        self._ids = itertools.count()
        self.n_seen = 0        # submissions observed (sampled or not)
        self.n_started = 0     # traces begun
        self.n_completed = 0   # traces finished (terminal reached)

    def begin(self) -> Optional[RequestTrace]:
        with self._lock:
            seen = self.n_seen
            self.n_seen += 1
            if seen % self.sample_every:
                return None
            self.n_started += 1
            return RequestTrace(next(self._ids), self)

    def _finish(self, trace: RequestTrace) -> None:
        with self._lock:
            if trace._done:
                return
            trace._done = True
            self.n_completed += 1
            self._ring.append(trace)

    def completed(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._ring)

    def dump(self, limit: Optional[int] = None) -> Dict[str, Any]:
        """JSON-ready artifact (the ``--trace-dump`` file).

        ``limit`` keeps only the *newest* N traces (the ring is oldest
        first) — what ``/trace?limit=N`` serves.
        """
        traces = self.completed()
        if limit is not None:
            if limit < 0:
                raise ValueError(f"limit must be >= 0, got {limit}")
            traces = traces[len(traces) - limit:] if limit else []
        with self._lock:
            head = {"n_seen": self.n_seen, "n_started": self.n_started,
                    "n_completed": self.n_completed,
                    "sample_every": self.sample_every,
                    "capacity": self.capacity}
        return {**head, "traces": [tr.to_dict() for tr in traces]}


# -- module-level tracer (the single global the hot path reads) --------------

_tracer: Optional[TraceLog] = None


def enable_tracing(sample_every: int = 1, capacity: int = 2048) -> TraceLog:
    """Install (and return) a fresh process-wide :class:`TraceLog`."""
    global _tracer
    _tracer = TraceLog(capacity=capacity, sample_every=sample_every)
    return _tracer


def disable_tracing() -> None:
    global _tracer
    _tracer = None


def get_tracer() -> Optional[TraceLog]:
    return _tracer


def begin_trace() -> Optional[RequestTrace]:
    """One new request timeline — None when tracing is off / not sampled."""
    tracer = _tracer
    return tracer.begin() if tracer is not None else None


def tadd(trace: Optional[RequestTrace], name: str,
         t: Optional[float] = None, **attrs) -> None:
    """Event append tolerant of untraced (None) requests."""
    if trace is not None:
        trace.add(name, t=t, **attrs)


def tfinish(trace: Optional[RequestTrace]) -> None:
    if trace is not None:
        trace.finish()
