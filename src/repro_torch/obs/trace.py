"""Tracing through the serving path: per-request timelines and the
serving worker's per-batch span log.

**Request timelines.** One request's life is a sequence of timestamped
events::

    submit -> admit -> enqueue -> dequeue -> batch-form
           -> jit-step-start -> jit-step-end -> complete

with the failure terminals ``shed`` (admission refused at the fleet
door), ``reject`` (single-engine queue bound), ``expired`` (deadline
passed while queued), ``cancelled``, and ``error``.  Spans are the gaps
between consecutive events — :meth:`RequestTrace.spans` derives them, so
queueing delay vs batch-forming delay vs step time are separable
per request, fleet-wide.  ``batch-form`` names the batch (``batch=<id>``)
whose spans the span log holds.

**The worker's batch timeline.** :class:`SpanLog` (one a process,
preallocated, bounded) records the spans of each batch on the thread
that serves it, in order: ``batcher.wait`` (for the first live request),
``batcher.gather`` (to the flush), ``batcher.form`` (the padded frames),
``engine.step`` holding ``step.copy_in`` / ``step.replay`` /
``step.copy_out`` / ``step.sync`` / ``step.unpack`` (a captured step) or
``step.eager``, then ``engine.resolve`` (predictions, stats and every
future).  Each span keeps its batch id, its parent span, its thread, and
its start and end on ``perf_counter``; each batch keeps its size, bucket,
flush kind and, for a timeout flush, how late the flush came; each
request its queue wait.  A wait that outlasts the consumer's poll is
several ``batcher.wait`` spans in a row, the last one carrying the batch.
:meth:`SpanLog.between` reads a window.

Cost model: both are **off by default**.  Request tracing is on while
:func:`enable_tracing` is; every untraced request carries ``None`` and
every instrumentation site is a single ``is not None`` check.  When
enabled, the deterministic ``sample_every`` knob traces every Nth
submission; completed traces land in a bounded ring buffer
(:class:`TraceLog`) whose JSON ``dump()`` is the ``--trace-dump``
artifact (with the worker's spans under ``"spans"``).  The span log
records while :func:`enable_tracing` is on or while any torch profiler
runs; then a span takes two ``perf_counter`` reads, a lock and a row of
the preallocated columns, and under a profiler enters a
``repro_torch::<name>`` range on the profiler's clock: 2.3 µs a span on
the host of an NVIDIA H100 machine, about ten a batch.  Off, a span site
costs one ``None`` check and one module attribute read (0.3-0.4 µs
there): no profiler range, no allocation.  ``python -m
repro_torch.bench.span_cost`` measures both.
"""
from __future__ import annotations

import array
import collections
import dataclasses
import itertools
import math
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch.autograd.profiler as _autograd_profiler

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
    "SPAN_NAMES",
    "FLUSH_KINDS",
    "SpanLog",
    "SpanWindow",
    "span",
    "span_log",
    "span_window",
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
        # the worker spans a dump carries start from here
        self.t_created = time.perf_counter()

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
        first) — what ``/trace?limit=N`` serves.  ``spans`` and
        ``batches`` are the span log's records since this log was
        enabled (with a ``limit``, since the first trace kept).
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
        out = [tr.to_dict() for tr in traces]
        since = (self.t_created if limit is None
                 else out[0]["t0"] if out else math.inf)
        window = _SPANS.between(since, math.inf) if _SPANS is not None else None
        return {**head, "traces": out,
                **(window.to_json() if window is not None
                   else {"spans": [], "batches": []})}


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


# -- the serving worker's span log -------------------------------------------

#: Span names, in the order a batch meets them.
SPAN_NAMES = ("batcher.wait", "batcher.gather", "batcher.form", "engine.step",
              "step.copy_in", "step.replay", "step.copy_out", "step.sync",
              "step.unpack", "step.eager", "engine.resolve")
_NAME_ID = {n: i for i, n in enumerate(SPAN_NAMES)}
_RANGE_NAMES = tuple(f"repro_torch::{n}" for n in SPAN_NAMES)

#: Why the batcher flushed a batch.
FLUSH_KINDS = ("size", "timeout", "pace", "close")
_KIND_ID = {k: i for i, k in enumerate(FLUSH_KINDS)}

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:
    _RecordFunctionFast = None


def _enter_range(name: str):
    """A profiler range named ``name`` entered now (the profiler stamps it
    on the clock of its device events): the fast C++ form where torch has
    it, else ``record_function``."""
    rng = (_RecordFunctionFast(name) if _RecordFunctionFast is not None
           else _autograd_profiler.record_function(name))
    rng.__enter__()
    return rng


class _Ring:
    """Preallocated columns, one record a row; once full, each new record
    overwrites the oldest and counts as ``dropped``.  Each column is a
    typed ``array.array`` (a row written item by item, cheaply) with a
    numpy view of it in ``cols``.  Every ring has a ``t0`` column (the
    record's start on ``perf_counter``); ``dropped_t0`` is the latest start
    among the records overwritten."""

    def __init__(self, capacity: int, **typecodes):
        self.capacity = capacity
        self.arrays = {k: array.array(tc, bytes(capacity * array.array(tc).itemsize))
                       for k, tc in typecodes.items()}
        self.cols = {k: np.frombuffer(a, a.typecode)
                     for k, a in self.arrays.items()}
        self._t0 = self.arrays["t0"]
        self.n = 0
        self.dropped = 0
        self.dropped_t0 = -math.inf

    def reserve(self) -> int:
        """The row for one new record (the caller holds the lock)."""
        i = self.n % self.capacity
        if self.n >= self.capacity:
            self.dropped += 1
            if self._t0[i] > self.dropped_t0:
                self.dropped_t0 = self._t0[i]
        self.n += 1
        return i

    def reserve_many(self, k: int) -> np.ndarray:
        """Rows for ``k`` new records (the caller holds the lock)."""
        idx = (self.n + np.arange(k)) % self.capacity
        lost = idx[max(0, self.capacity - self.n):]
        if len(lost):
            self.dropped += len(lost)
            self.dropped_t0 = max(self.dropped_t0,
                                  float(self.cols["t0"][lost].max()))
        self.n += k
        return idx

    def select(self, a: float, b: float) -> Dict[str, np.ndarray]:
        """Copies of the records that started in [a, b), oldest first."""
        n = min(self.n, self.capacity)
        idx = (np.arange(self.n - n, self.n)) % self.capacity
        t0 = self.cols["t0"][idx]
        idx = idx[(t0 >= a) & (t0 < b)]
        return {k: c[idx] for k, c in self.cols.items()}


class _Scope:
    """``with`` form of :meth:`SpanLog.enter` / :meth:`SpanLog.exit`."""

    __slots__ = ("log", "name")

    def __init__(self, log: "SpanLog", name: str):
        self.log = log
        self.name = name

    def __enter__(self):
        self.log.enter(self.name)

    def __exit__(self, *exc):
        self.log.exit()
        return False


class _Off:
    """The span of a site while nothing records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class SpanLog:
    """The serving worker's per-batch spans, batches and queue waits, in
    three bounded rings allocated once.

    A thread opens spans with :meth:`enter` and closes its innermost with
    :meth:`exit`; an open span is the parent of the spans it holds.  A
    thread's spans belong to its current batch (:meth:`new_batch`, or -1
    while none forms), read when each span closes.
    """

    def __init__(self, capacity: int = 1 << 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._batch_ids = itertools.count()
        self.spans = _Ring(capacity, name="h", id="q", parent="q",
                           batch="q", thread="q", t0="d", t1="d")
        self.batches = _Ring(max(1, capacity // 4), batch="q", n_real="i",
                             bucket="i", kind="b", late_s="d", t0="d")
        self.waits = _Ring(capacity, batch="q", wait_s="d", t0="d")
        self._scopes = {n: _Scope(self, n) for n in SPAN_NAMES}

    def _state(self):
        st = self._local
        if not hasattr(st, "stack"):
            st.stack = []
            st.batch = -1
            st.batch_t0 = math.nan
            st.thread = threading.get_native_id()
        return st

    # -- recording (the thread that serves the batch) -----------------------

    def new_batch(self) -> int:
        """Start this thread's next batch (at its first live request)."""
        st = self._state()
        st.batch = next(self._batch_ids)
        st.batch_t0 = time.perf_counter()
        return st.batch

    def no_batch(self) -> None:
        """This thread forms no batch until the next :meth:`new_batch`."""
        self._state().batch = -1

    def current_batch(self) -> int:
        return self._state().batch

    def enter(self, name: str) -> None:
        """Open span ``name`` on this thread (a child of its innermost)."""
        st = self._state()
        rng = (_enter_range(_RANGE_NAMES[_NAME_ID[name]])
               if _autograd_profiler._is_profiler_enabled else None)
        parent = st.stack[-1][1] if st.stack else -1
        st.stack.append((_NAME_ID[name], next(self._ids), parent, rng,
                         time.perf_counter()))

    def exit(self) -> None:
        """Close this thread's innermost open span and record it."""
        t1 = time.perf_counter()
        st = self._state()
        name, sid, parent, rng, t0 = st.stack.pop()
        if rng is not None:
            rng.__exit__(None, None, None)
        ring = self.spans
        r = ring.arrays
        with self._lock:
            i = ring.reserve()
            r["name"][i] = name
            r["id"][i] = sid
            r["parent"][i] = parent
            r["batch"][i] = st.batch
            r["thread"][i] = st.thread
            r["t0"][i] = t0
            r["t1"][i] = t1

    def span(self, name: str) -> _Scope:
        """``with log.span(name):`` — :meth:`enter` then :meth:`exit`."""
        return self._scopes[name]

    def record_batch(self, n_real: int, bucket: int, kind: str,
                     late_s: float, waits_s: Iterable[float]) -> None:
        """This thread's current batch as flushed: its size, bucket, flush
        kind, lateness (a timeout flush's, else NaN) and each request's
        queue wait, on the batcher's clock."""
        st = self._state()
        waits = np.fromiter(waits_s, np.float64)
        with self._lock:
            i = self.batches.reserve()
            r = self.batches.arrays
            r["batch"][i] = st.batch
            r["n_real"][i] = n_real
            r["bucket"][i] = bucket
            r["kind"][i] = _KIND_ID[kind]
            r["late_s"][i] = late_s
            r["t0"][i] = st.batch_t0
            idx = self.waits.reserve_many(len(waits))
            c = self.waits.cols
            c["batch"][idx] = st.batch
            c["wait_s"][idx] = waits
            c["t0"][idx] = st.batch_t0

    # -- reading --------------------------------------------------------------

    @property
    def dropped(self) -> int:
        """Records overwritten so far, in all three rings."""
        with self._lock:
            return self.spans.dropped + self.batches.dropped + self.waits.dropped

    def between(self, t0: float, t1: float) -> "SpanWindow":
        """The spans, batches and waits that started in [t0, t1) (a batch
        and its waits start at its first live request), and whether a
        record that started at or after ``t0`` was overwritten."""
        with self._lock:
            spans = self.spans.select(t0, t1)
            batches = self.batches.select(t0, t1)
            waits = self.waits.select(t0, t1)
            dropped = any(r.dropped_t0 >= t0
                          for r in (self.spans, self.batches, self.waits))
        spans["name"] = np.asarray(SPAN_NAMES)[spans["name"]]
        batches["kind"] = np.asarray(FLUSH_KINDS)[batches["kind"]]
        return SpanWindow(spans=spans, batches=batches, waits=waits,
                          dropped=dropped)


@dataclasses.dataclass
class SpanWindow:
    """What :meth:`SpanLog.between` read: column arrays, oldest first.

    ``spans``: ``name``, ``id``, ``parent`` (-1 at a batch's top level),
    ``batch`` (-1 outside a batch), ``thread``, ``t0``, ``t1``;
    ``batches``: ``batch``, ``n_real``, ``bucket``, ``kind``, ``late_s``,
    ``t0``; ``waits``: ``batch``, ``wait_s``, ``t0``.
    """

    spans: Dict[str, np.ndarray]
    batches: Dict[str, np.ndarray]
    waits: Dict[str, np.ndarray]
    dropped: bool

    def seconds(self, name: str) -> np.ndarray:
        """Wall seconds of each span named ``name``."""
        sel = self.spans["name"] == name
        return self.spans["t1"][sel] - self.spans["t0"][sel]

    def to_json(self) -> Dict[str, List[Dict[str, Any]]]:
        """``{"spans": [...], "batches": [...]}`` as plain JSON values."""
        sp, b = self.spans, self.batches
        return {
            "spans": [{"name": str(sp["name"][i]), "id": int(sp["id"][i]),
                       "parent": int(sp["parent"][i]),
                       "batch": int(sp["batch"][i]),
                       "thread": int(sp["thread"][i]),
                       "t0": float(sp["t0"][i]), "t1": float(sp["t1"][i])}
                      for i in range(len(sp["id"]))],
            "batches": [{"batch": int(b["batch"][i]),
                         "n_real": int(b["n_real"][i]),
                         "bucket": int(b["bucket"][i]),
                         "flush": str(b["kind"][i]),
                         "late_s": (None if math.isnan(b["late_s"][i])
                                    else float(b["late_s"][i])),
                         "t0": float(b["t0"][i])}
                        for i in range(len(b["batch"]))],
        }


_SPANS: Optional[SpanLog] = None
_SPANS_LOCK = threading.Lock()


def _the_log() -> SpanLog:
    global _SPANS
    with _SPANS_LOCK:
        if _SPANS is None:
            _SPANS = SpanLog()
        return _SPANS


def span_log() -> Optional[SpanLog]:
    """The process's span log while it records (request tracing on, or a
    torch profiler running), else None."""
    if _tracer is None and not _autograd_profiler._is_profiler_enabled:
        return None
    return _SPANS if _SPANS is not None else _the_log()


def span(name: str):
    """``with span(name):`` records span ``name`` while the log records;
    otherwise a shared no-op."""
    if _tracer is None and not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return (_SPANS if _SPANS is not None else _the_log())._scopes[name]


def span_window(t0: float, t1: float) -> Optional[SpanWindow]:
    """The process log's records that started in [t0, t1), or None where
    there is no span there or the ring overwrote some."""
    log = _SPANS
    if log is None:
        return None
    w = log.between(t0, t1)
    return None if w.dropped or not len(w.spans["id"]) else w
