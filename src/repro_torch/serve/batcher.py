"""Dynamic micro-batching request queue for the serving tier.

The paper's FPGA accelerator sustains 23.5 MS/s because its pipeline never sees a
control bubble: every frame enters a fixed iteration schedule.  The
software analogue is a micro-batcher that gathers individual requests into
**fixed-shape** batches: batch sizes are drawn from a static bucket ladder
(powers of two up to ``max_batch``) and the tail of a partially-filled
bucket is zero-padded, so the serving step only ever sees ``len(buckets)``
distinct shapes and never re-specializes under load.

Flush policy (the standard dynamic-batching trade-off):

* **size flush** — the batch reaches ``max_batch`` requests: ship now,
  throughput-optimal;
* **timeout flush** — ``max_delay`` elapsed since the batch started
  forming: ship what we have (padded up to the smallest covering bucket),
  bounding added tail latency to ``max_delay`` under light traffic;
* **pace gate** (``pace_ms > 0``) — consecutive flushes are at least
  ``pace_ms`` apart, bounding batch-launch rate (the fleet tier uses this
  as the per-replica service-rate cap; the batch keeps filling while the
  gate holds, so pacing *improves* batching efficiency under load).

The queue is **priority- and deadline-aware** (the fleet tier's request
model):

* requests carry a priority class (``realtime`` > ``bulk``); dequeue is
  smooth-weighted round-robin across the non-empty classes, so under a
  saturated queue realtime requests observe strictly lower queueing delay
  while bulk traffic still drains (no starvation);
* requests may carry an absolute deadline; an expired request **fails
  fast** at dequeue time with :class:`DeadlineExceeded` instead of
  occupying a micro-batch slot (likewise a request whose future was
  cancelled is dropped without a slot);
* ``max_queue`` bounds the backlog: ``submit`` raises :class:`QueueFull`
  once the bound is hit — the admission-control primitive the fleet
  router's load shedding builds on (shed at the door, never queue
  unboundedly).

``MicroBatcher`` is transport-only — it knows nothing about models or
backends; the engine's worker loops consume :class:`MicroBatch` objects
and resolve each request's :class:`ServeFuture`.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import heapq
import itertools
import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.trace import span, span_log, tadd, tfinish

__all__ = [
    "ServeFuture",
    "Request",
    "MicroBatch",
    "DeadlineExceeded",
    "QueueFull",
    "EngineClosed",
    "PRIORITIES",
    "DEFAULT_PRIORITY_WEIGHTS",
    "make_buckets",
    "bucket_for",
    "MicroBatcher",
]

#: Priority classes, highest first.  ``realtime`` models the paper's
#: streaming deployment (a frame is worthless once its decision window
#: passes); ``bulk`` models offline re-scoring / shadow traffic.
PRIORITIES: Tuple[str, ...] = ("realtime", "bulk")

#: Default dequeue weights: under a saturated queue realtime receives
#: ~8/9 of the batch slots, bulk the rest (weighted, not strict, so bulk
#: can never starve).
DEFAULT_PRIORITY_WEIGHTS: Dict[str, float] = {"realtime": 8.0, "bulk": 1.0}


class ServeFuture(concurrent.futures.Future):
    """Future for one serve request (stdlib ``Future`` semantics).

    Resolved by the engine's worker loop — ``result(timeout=...)`` blocks
    until the micro-batch containing this request has been served, or
    raises the worker's exception / a shutdown ``RuntimeError`` / a
    :class:`DeadlineExceeded` if the request expired while queued.

    ``trace`` carries the request's :class:`~repro_torch.obs.trace.RequestTrace`
    (None when tracing is off / unsampled) so callers holding only the
    future can read the span timeline after resolution.
    """

    trace = None


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed while it was still queued."""


class QueueFull(RuntimeError):
    """Admission rejected: the batcher's ``max_queue`` bound is hit."""


class EngineClosed(RuntimeError):
    """Submit refused: the batcher (and the engine over it) has closed.

    A dedicated type so callers that route around a retiring replica (the
    fleet router) can distinguish "this engine is shutting down — try the
    next one" from a genuine engine fault, which must propagate.
    """


@dataclasses.dataclass
class Request:
    """One enqueued classification request (a single I/Q frame)."""

    seq: int
    iq: np.ndarray            # (IC, L) float32
    t_enqueue: float
    future: ServeFuture
    deadline: Optional[float] = None   # absolute, on the batcher's clock
    priority: str = "realtime"
    trace: Optional[object] = None     # RequestTrace (None when untraced)


@dataclasses.dataclass
class MicroBatch:
    """A flushed batch: real requests plus zero-padded tail rows."""

    requests: List[Request]
    bucket: int               # fixed batch shape this batch was padded to
    frames: np.ndarray        # (bucket, IC, L) — rows >= n_real are padding
    queue_depth: int          # backlog remaining in the queue at flush time

    @property
    def n_real(self) -> int:
        return len(self.requests)

    @property
    def n_padded(self) -> int:
        return self.bucket - len(self.requests)


def make_buckets(max_batch: int, align: int = 1) -> Tuple[int, ...]:
    """Power-of-two bucket ladder up to ``max_batch``, ``align``-aligned.

    ``align`` is the device count of the serving mesh: every bucket must be
    divisible by it so the batch axis shards evenly.  A ``max_batch`` that
    is not itself aligned is rounded **down** (never above the caller's
    sizing cap), but never below ``align``.
    """
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if align < 1:
        raise ValueError(f"align must be >= 1, got {align}")
    top = max(align, (max_batch // align) * align)
    sizes = []
    b = align
    while b < top:
        sizes.append(b)
        b *= 2
    sizes.append(top)
    return tuple(sorted(set(sizes)))


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket covering ``n`` requests (caller caps n at max)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class MicroBatcher:
    """Bounded-delay dynamic micro-batcher over priority-class queues."""

    def __init__(
        self,
        frame_shape: Tuple[int, int],
        max_batch: Optional[int] = None,
        max_delay_ms: float = 5.0,
        buckets: Optional[Sequence[int]] = None,
        align: int = 1,
        max_queue: Optional[int] = None,
        priority_weights: Optional[Dict[str, float]] = None,
        pace_ms: float = 0.0,
        clock=time.perf_counter,
        obs_counters: Optional[Dict[str, object]] = None,
    ):
        self.frame_shape = tuple(frame_shape)
        if buckets:
            self.buckets = tuple(sorted(buckets))
            if max_batch is not None and max_batch != self.buckets[-1]:
                raise ValueError(
                    f"max_batch={max_batch} conflicts with explicit buckets "
                    f"{self.buckets} (their top is the max batch — pass one "
                    "or the other, or make them agree)")
        else:
            self.buckets = make_buckets(64 if max_batch is None else max_batch,
                                        align)
        if any(b % align for b in self.buckets):
            raise ValueError(
                f"buckets {self.buckets} must all be multiples of align={align}")
        self.max_batch = self.buckets[-1]
        self.max_delay_s = max_delay_ms / 1e3
        self.max_queue = max_queue
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.pace_s = pace_ms / 1e3
        weights = dict(priority_weights or DEFAULT_PRIORITY_WEIGHTS)
        unknown = set(weights) - set(PRIORITIES)
        if unknown:
            raise ValueError(f"unknown priority classes {sorted(unknown)}; "
                             f"valid: {PRIORITIES}")
        if any(w <= 0 for w in weights.values()):
            raise ValueError(f"priority weights must be > 0, got {weights}")
        for p in PRIORITIES:  # every class dequeues even if not weighted
            weights.setdefault(p, 1.0)
        self._weights = weights
        self._clock = clock
        # one FIFO per priority class; dequeue interleaves them by smooth
        # weighted round-robin (credit scheme, deterministic — no RNG)
        self._pending: Dict[str, collections.deque] = {
            p: collections.deque() for p in PRIORITIES}
        self._credit: Dict[str, float] = {p: 0.0 for p in PRIORITIES}
        self._seq = itertools.count()
        self._last_seq = -1    # highest seq ever submitted
        # exact un-handed tracking for drain_barrier.  A high-water-mark
        # seq is NOT enough: weighted round-robin dequeues realtime ahead
        # of bulk, so a high realtime seq can be handed while lower-seq
        # bulk requests are still queued.  Min-heap of un-handed seqs with
        # lazy deletion (seqs handed out of order park in _handed_out_of_
        # order until they surface at the heap top); both structures are
        # bounded by the live backlog.
        self._unhanded: List[int] = []
        self._handed_out_of_order: set = set()
        self._handed = threading.Condition()
        self._closed = False
        # one lock/condition covers queue state, admission, the close flag
        # and the pace gate: a submit either lands before close (and is
        # served or drained) or raises — no request can slip into the
        # queue after drain() has emptied it
        self._cond = threading.Condition()
        self._next_flush = 0.0  # pace gate: earliest next flush time
        # counters (exact totals, exported by the engine's stats)
        self.n_expired = 0     # requests failed fast on a passed deadline
        self.n_rejected = 0    # submits refused by the max_queue bound
        self.n_cancelled = 0   # cancelled futures dropped at dequeue
        # optional registry mirrors ({"expired"/"rejected"/"cancelled":
        # inc()-able}) — the engine wires its labeled metric children here
        self._obs = dict(obs_counters or {})

    def _obs_inc(self, key: str) -> None:
        c = self._obs.get(key)
        if c is not None:
            c.inc()

    # -- producer side ------------------------------------------------------

    def now(self) -> float:
        """The batcher's clock (deadlines are absolute on this clock)."""
        return self._clock()

    def submit(self, iq: np.ndarray, *, deadline: Optional[float] = None,
               priority: str = "realtime", trace=None) -> ServeFuture:
        """Enqueue one (IC, L) frame; returns a future for its prediction.

        ``deadline`` is absolute (``batcher.now() + budget_s``); ``None``
        never expires.  Raises :class:`QueueFull` when the ``max_queue``
        admission bound is hit — the caller (router) sheds instead of
        queueing unboundedly.  ``trace`` is the request's optional
        :class:`~repro_torch.obs.trace.RequestTrace`; the batcher records the
        queue-transit events on it (the *caller* records the terminal on
        an admission refusal — a router may retry another replica).
        """
        iq = np.asarray(iq, dtype=np.float32)
        if iq.shape != self.frame_shape:
            raise ValueError(
                f"expected frame of shape {self.frame_shape}, got {iq.shape}")
        if priority not in self._pending:
            raise ValueError(f"unknown priority {priority!r}; "
                             f"valid: {PRIORITIES}")
        with self._cond:
            if self._closed:
                raise EngineClosed("MicroBatcher is closed")
            if (self.max_queue is not None
                    and self._depth_locked() >= self.max_queue):
                self.n_rejected += 1
                self._obs_inc("rejected")
                raise QueueFull(
                    f"admission rejected: {self.max_queue} requests queued")
            fut = ServeFuture()
            fut.trace = trace
            seq = next(self._seq)
            self._last_seq = seq
            with self._handed:
                heapq.heappush(self._unhanded, seq)
            tadd(trace, "enqueue", queue_depth=self._depth_locked(),
                 priority=priority)
            self._pending[priority].append(
                Request(seq=seq, iq=iq, t_enqueue=self._clock(), future=fut,
                        deadline=deadline, priority=priority, trace=trace))
            self._cond.notify()
        return fut

    def _depth_locked(self) -> int:
        return sum(len(d) for d in self._pending.values())

    def qsize(self) -> int:
        with self._cond:
            return self._depth_locked()

    def qsizes(self) -> Dict[str, int]:
        """Per-priority-class backlog snapshot."""
        with self._cond:
            return {p: len(d) for p, d in self._pending.items()}

    def drain_barrier(self, timeout: Optional[float] = None) -> bool:
        """Block until every request enqueued *before this call* has been
        handed to a consumer batch (or failed fast); False on timeout.

        This is the hot-swap drain point: after flipping the primary
        version, waiting on the barrier guarantees the pre-flip backlog
        has been batched (on the old or new plan — either way it will be
        served, never dropped).  Requests submitted after the call do not
        extend the wait.

        The wait is on *every* seq <= the snapshot, not a high-water
        mark: priority dequeue hands requests out of seq order, so the
        barrier holds until the smallest un-handed seq moves past the
        target.
        """
        with self._cond:
            target = self._last_seq
        deadline = None if timeout is None else self._clock() + timeout
        with self._handed:
            while self._unhanded and self._unhanded[0] <= target:
                remaining = None
                if deadline is not None:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        return False
                self._handed.wait(timeout=remaining)
        return True

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def close(self) -> None:
        """Wake all worker loops; pending get_batch calls return None."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def drain(self) -> List[Request]:
        """Remove and return every still-queued request (after close).

        The engine resolves their futures with an error so no caller is
        left blocking on a request that will never be served.
        """
        with self._cond:
            if not self._closed:
                raise RuntimeError("drain() is only valid after close()")
            pending: List[Request] = []
            for d in self._pending.values():
                pending.extend(d)
                d.clear()
            if pending:
                # drained requests count as handled (their futures are
                # failed by the engine), so a pending drain_barrier wakes
                # instead of waiting on requests that will never batch
                self._mark_handed_all(r.seq for r in pending)
            return pending

    # -- consumer side ------------------------------------------------------

    def _pop_locked(self, expired: List[Request]) -> Optional[Request]:
        """Pop the next live request by weighted priority; None if empty.

        Expired requests are moved to ``expired`` (the caller fails their
        futures *outside* the lock — future callbacks must never run under
        it); cancelled futures are dropped on the spot.  Both count as
        handed so drain barriers never wait on them.
        """
        now = self._clock()
        while True:
            avail = [p for p in PRIORITIES if self._pending[p]]
            if not avail:
                return None
            if len(avail) == 1:
                pick = avail[0]
            else:
                # smooth weighted round-robin (the nginx scheme): credit
                # every non-empty class, pick the richest, debit it by the
                # total — exactly proportional over any window, no bursts
                total = 0.0
                for p in avail:
                    self._credit[p] += self._weights[p]
                    total += self._weights[p]
                pick = max(avail, key=lambda p: (self._credit[p],
                                                 -PRIORITIES.index(p)))
                self._credit[pick] -= total
            r = self._pending[pick].popleft()
            if r.future.cancelled():
                self.n_cancelled += 1
                self._obs_inc("cancelled")
                tadd(r.trace, "cancelled", at="dequeue")
                tfinish(r.trace)
                self._mark_handed(r.seq)
                continue
            if r.deadline is not None and now > r.deadline:
                self.n_expired += 1
                self._obs_inc("expired")
                tadd(r.trace, "expired", at="dequeue")
                tfinish(r.trace)
                self._mark_handed(r.seq)
                expired.append(r)
                continue
            tadd(r.trace, "dequeue")
            return r

    #: sentinel: a gathering round ended with no live request — fail its
    #: expired futures now and start another round
    _RETRY = object()

    def get_batch(self, timeout: Optional[float] = None) -> Optional[MicroBatch]:
        """Block for the next batch; None on timeout or close.

        Waits for a first live request, then keeps draining the queues
        until the batch is full (**size flush**) or ``max_delay`` has
        elapsed since the batch started forming (**timeout flush**).  With
        a pace gate the batch keeps filling until the gate opens, and
        flushes are serialized at least ``pace_ms`` apart.

        Expired requests are failed (outside the lock) at the end of
        *every* gathering round, never held until this call returns — a
        consumer blocking with ``timeout=None`` on an idle queue cannot
        leave ``DeadlineExceeded`` futures unresolved past their round.
        """
        wait_deadline = None if timeout is None else self._clock() + timeout
        log = span_log()   # None unless tracing or a profiler is on
        while True:
            expired: List[Request] = []
            if log is not None:
                log.no_batch()
                log.enter("batcher.wait")
            try:
                with self._cond:
                    out = self._gather_round_locked(wait_deadline, expired,
                                                    log)
            finally:
                if log is not None:   # the wait, or the gather after it
                    log.exit()
            if expired:
                err = DeadlineExceeded(
                    "request deadline expired while queued")
                for r in expired:
                    _fail_quietly(r.future, err)
            if out is self._RETRY:
                continue
            if out is None:
                return None
            reqs, depth, kind, t_flush, late_s = out
            bucket = bucket_for(len(reqs), self.buckets)
            with span("batcher.form"):
                frames = np.zeros((bucket,) + self.frame_shape,
                                  dtype=np.float32)
                # trace timestamps stay on perf_counter even under a fake
                # batcher clock — spans must be comparable across events
                t_form = time.perf_counter()
                batch_id = log.current_batch() if log is not None else None
                for i, r in enumerate(reqs):
                    frames[i] = r.iq
                    tadd(r.trace, "batch-form", t=t_form, bucket=bucket,
                         n_real=len(reqs), n_padded=bucket - len(reqs),
                         batch=batch_id)
            if log is not None:
                log.record_batch(len(reqs), bucket, kind, late_s,
                                 (t_flush - r.t_enqueue for r in reqs))
            return MicroBatch(requests=reqs, bucket=bucket, frames=frames,
                              queue_depth=depth)

    def _gather_round_locked(self, wait_deadline: Optional[float],
                             expired: List[Request], log=None):
        """One gathering round under ``_cond``: a ``(reqs, depth, kind,
        t_flush, late_s)`` batch (the flush's kind of :data:`~repro_torch.
        obs.trace.FLUSH_KINDS`, its time on the batcher's clock and, for a
        timeout flush, how far past ``max_delay`` after the first pop it
        came, else NaN), None (timeout / close), or ``_RETRY`` (round
        produced only expired/cancelled requests — the caller fails
        ``expired`` outside the lock and calls again).  With a span
        ``log``, the first live pop ends the caller's open
        ``batcher.wait`` span, starts the batch and opens
        ``batcher.gather`` in its place."""
        # -- phase 1: first live request (or timeout / close) ---------------
        while True:
            if self._closed:
                return None
            first = self._pop_locked(expired)
            if first is not None:
                break
            if expired:
                # nothing live to batch yet but this round already popped
                # expired requests: hand them back for prompt failure
                # instead of holding them while blocked on the condition
                return self._RETRY
            remaining = None
            if wait_deadline is not None:
                remaining = wait_deadline - self._clock()
                if remaining <= 0:
                    return None
            self._cond.wait(timeout=remaining)
        if log is not None:
            log.new_batch()
            log.exit()
            log.enter("batcher.gather")
        # -- phase 2: gather until full / max_delay / pace -------------------
        reqs = [first]
        form_deadline = self._clock() + self.max_delay_s
        gather_deadline = max(form_deadline, self._next_flush)
        waited_at_gate = False
        while not self._closed:
            now = self._clock()
            full = len(reqs) >= self.max_batch
            if now >= gather_deadline and not full:
                break
            if full and now >= self._next_flush:
                break
            if not full:
                nxt = self._pop_locked(expired)
                if nxt is not None:
                    reqs.append(nxt)
                    continue
            # full-but-paced waits for the gate; partial waits for more
            # requests (a submit notifies) or the forming deadline
            until = self._next_flush if full else gather_deadline
            waited_at_gate |= full
            self._cond.wait(timeout=max(0.0, until - now))
        # -- phase 3: pace gate — serialize flushes ---------------------------
        if self.pace_s > 0 and not self._closed:
            while True:
                now = self._clock()
                if now >= self._next_flush or self._closed:
                    break
                waited_at_gate = True
                self._cond.wait(timeout=self._next_flush - now)
        full = len(reqs) >= self.max_batch
        if self._closed:
            kind = "close"
        elif waited_at_gate or (not full and gather_deadline > form_deadline):
            kind = "pace"     # held by the pace gate, or gathered up to it
        else:
            kind = "size" if full else "timeout"
        # flush-time recheck: forming/pacing can outlast a deadline, and a
        # gathered request may have expired or been cancelled since it was
        # popped — it must not ride into the serving step in a batch slot
        self._mark_handed_all(r.seq for r in reqs)
        now = self._clock()
        live = []
        for r in reqs:
            if r.future.cancelled():
                self.n_cancelled += 1
                self._obs_inc("cancelled")
                tadd(r.trace, "cancelled", at="flush")
                tfinish(r.trace)
            elif r.deadline is not None and now > r.deadline:
                self.n_expired += 1
                self._obs_inc("expired")
                tadd(r.trace, "expired", at="flush")
                tfinish(r.trace)
                expired.append(r)
            else:
                live.append(r)
        if not live:
            return self._RETRY
        if self.pace_s > 0:
            # the pace slot is consumed only by a real flush —
            # all-expired rounds launch no compute
            self._next_flush = self._clock() + self.pace_s
        late_s = now - form_deadline if kind == "timeout" else math.nan
        return live, self._depth_locked(), kind, now, late_s

    def _mark_handed(self, seq: int) -> None:
        self._mark_handed_all((seq,))

    def _mark_handed_all(self, seqs: Iterable[int]) -> None:
        with self._handed:
            self._handed_out_of_order.update(seqs)
            heap = self._unhanded
            while heap and heap[0] in self._handed_out_of_order:
                self._handed_out_of_order.discard(heapq.heappop(heap))
            self._handed.notify_all()


def _fail_quietly(fut, err: BaseException) -> None:
    """set_exception tolerant of cancelled / already-resolved futures."""
    if fut.done():
        return
    try:
        fut.set_exception(err)
    except Exception:  # noqa: BLE001 — lost a cancel race; nothing to do
        pass
