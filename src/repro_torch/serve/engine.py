"""Async AMC serving engine: queue -> micro-batcher -> worker loops.

Port of ``AsyncAMCServeEngine`` and ``ServeStats`` from
``repro/serve/engine.py``.  Requests queue in the
:class:`~repro_torch.serve.batcher.MicroBatcher`, which flushes them as
fixed-shape buckets; a worker thread runs each bucket through the serving
step on the engine's device and resolves the requests' futures.

The serving step is ``iq -> plan.preferred_batch()(sigma_delta_encode_batch(
iq, T))``: Σ-Δ encoding in torch ops on the device, then — for the default
``cuda_fused`` backend — one launch of the whole-network kernel.  It runs
eagerly (no ``torch.compile``, no CUDA graph).

Not ported yet, and refused with ``NotImplementedError``: ``backend="auto"``
and ``"per-layer"`` (autotuning), mesh serving, model versions and
hot-swap, activity counting and gauges, the metrics registry, and LSQ
quantized serving.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.data.pipeline import sigma_delta_encode_batch
from repro_torch.device import resolve_device
from repro_torch.models.graph import compile_snn
from repro_torch.models.snn import SNNConfig
from repro_torch.obs.trace import begin_trace, tadd, tfinish
from repro_torch.plan import compile_plan
from repro_torch.serve.batcher import EngineClosed, MicroBatcher, QueueFull

__all__ = ["AsyncAMCServeEngine", "ServeStats"]


@dataclasses.dataclass
class ServeStats:
    # histories are bounded: percentiles/means cover the newest MAX_SAMPLES
    MAX_SAMPLES = 65536

    requests: int = 0
    batches: int = 0
    wall_s: float = 0.0
    backend: str = ""
    backend_batch_totals: Dict[str, int] = dataclasses.field(default_factory=dict)
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    queue_depths: List[int] = dataclasses.field(default_factory=list)
    padded_frames: int = 0

    def record_batch(self, backend: str, queue_depth: Optional[int] = None,
                     padded: int = 0) -> None:
        self.batches += 1
        self.padded_frames += padded
        self.backend_batch_totals[backend] = (
            self.backend_batch_totals.get(backend, 0) + 1)
        if queue_depth is not None:
            self.queue_depths.append(queue_depth)
            if len(self.queue_depths) > self.MAX_SAMPLES:
                del self.queue_depths[: -self.MAX_SAMPLES]

    def record_latencies(self, values) -> None:
        self.latencies_s.extend(values)
        if len(self.latencies_s) > self.MAX_SAMPLES:
            del self.latencies_s[: -self.MAX_SAMPLES]

    def throughput_samples_per_s(self, frame_len: int = 128) -> float:
        return self.requests * frame_len / self.wall_s if self.wall_s else 0.0

    def throughput_fps(self) -> float:
        """Requests (frames) classified per wall second."""
        return self.requests / self.wall_s if self.wall_s else 0.0

    def latency_percentile(self, q: float) -> float:
        if not self.latencies_s:
            return 0.0
        return float(np.percentile(self.latencies_s, q))

    @property
    def p50_ms(self) -> float:
        return self.latency_percentile(50.0) * 1e3

    @property
    def p95_ms(self) -> float:
        return self.latency_percentile(95.0) * 1e3

    @property
    def p99_ms(self) -> float:
        return self.latency_percentile(99.0) * 1e3

    def backend_batch_counts(self) -> Dict[str, int]:
        return dict(self.backend_batch_totals)

    def mean_queue_depth(self) -> float:
        return float(np.mean(self.queue_depths)) if self.queue_depths else 0.0

    def summary(self) -> dict:
        return {
            "requests": self.requests,
            "batches": self.batches,
            "backend": self.backend,
            "backend_batch_counts": self.backend_batch_counts(),
            "throughput_fps": self.throughput_fps(),
            "throughput_samples_per_s": self.throughput_samples_per_s(),
            "p50_ms": self.p50_ms,
            "p95_ms": self.p95_ms,
            "p99_ms": self.p99_ms,
            "mean_queue_depth": self.mean_queue_depth(),
            "padded_frames": self.padded_frames,
            "wall_s": self.wall_s,
        }


def _fail_future(fut, err: BaseException) -> None:
    """set_exception tolerant of callers that cancelled or already-done."""
    if fut.done():
        return
    try:
        fut.set_exception(err)
    except concurrent.futures.InvalidStateError:  # lost a cancel race
        pass


_WAITING = ("auto", "per-layer")


class AsyncAMCServeEngine:
    """Serving tier: ``submit`` -> micro-batcher -> worker loops -> futures.

    Usage::

        engine = AsyncAMCServeEngine(params, SNNConfig(), masks,
                                     backend="cuda_fused", max_batch=64)
        pred = engine.submit(iq_frame).result()   # (2, L) -> class id
        preds = engine.classify(iq_frames)        # (N, 2, L) -> (N,)
        engine.close()

    Runs on the card unless ``device="cpu"`` is given; without a CUDA
    device it raises.
    """

    def __init__(
        self,
        params,
        cfg: SNNConfig,
        masks=None,
        *,
        backend: str = "cuda_fused",
        max_batch: Optional[int] = None,   # default 64 (or buckets[-1])
        max_delay_ms: float = 5.0,
        buckets: Optional[Sequence[int]] = None,
        workers: int = 1,
        max_queue: Optional[int] = None,
        pace_ms: float = 0.0,
        priority_weights=None,
        warmup: bool = True,
        name: Optional[str] = None,
        device=None,
        mesh=None,
        count_activity: bool = False,
        lsq_scales=None,
    ):
        if backend in _WAITING:
            raise NotImplementedError(f"backend={backend!r} (autotuning) is "
                                      "not ported yet; name a backend")
        if mesh is not None:
            raise NotImplementedError("mesh serving is not ported yet")
        if count_activity:
            raise NotImplementedError("activity counting is not ported yet")
        if lsq_scales is not None:
            raise NotImplementedError("quantized serving is not ported yet")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.name = name if name is not None else "engine"
        self.backend = backend
        self.program = compile_snn(cfg)
        self.plan = compile_plan(self.program, params, masks=masks,
                                 assignment=backend, device=self.device)
        self._batch_fn = self.plan.preferred_batch()

        ic0 = cfg.conv_specs[0][1]
        self.batcher = MicroBatcher(
            frame_shape=(ic0, cfg.input_width), max_batch=max_batch,
            max_delay_ms=max_delay_ms, buckets=buckets, max_queue=max_queue,
            pace_ms=pace_ms, priority_weights=priority_weights)
        self.stats = ServeStats(backend=backend)

        if warmup:  # run every bucket shape once before taking traffic
            for b in self.batcher.buckets:
                self.step(np.zeros((b, ic0, cfg.input_width), np.float32))

        self._lock = threading.Lock()
        self._t_first_enqueue = float("inf")  # start of the serving window
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"amc-serve-worker-{i}")
            for i in range(max(1, workers))
        ]
        for t in self._threads:
            t.start()

    # -- serving step -------------------------------------------------------

    def step(self, iq: np.ndarray) -> np.ndarray:
        """(B, IC, L) raw I/Q -> (B, n_classes) logits, on the host."""
        with torch.inference_mode():
            x = torch.as_tensor(iq, dtype=torch.float32, device=self.device)
            frames = sigma_delta_encode_batch(x, self.cfg.timesteps)
            return self._batch_fn(frames).cpu().numpy()

    # -- worker loop --------------------------------------------------------

    def _worker(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            batch = self.batcher.get_batch(timeout=0.1)
            if batch is None:
                continue
            try:
                t_step0 = time.perf_counter()
                logits = self.step(batch.frames)
                t_step1 = time.perf_counter()
                preds = logits.argmax(-1).astype(np.int32)
                n_real = batch.n_real
                t_done = time.perf_counter()
                with self._lock:
                    batch_first = min(r.t_enqueue for r in batch.requests)
                    self._t_first_enqueue = min(self._t_first_enqueue,
                                                batch_first)
                    st = self.stats
                    st.requests += n_real
                    st.record_batch(self.backend,
                                    queue_depth=batch.queue_depth,
                                    padded=batch.n_padded)
                    st.record_latencies(t_done - r.t_enqueue
                                        for r in batch.requests)
                    st.wall_s = max(st.wall_s, t_done - self._t_first_enqueue)
                for r in batch.requests:
                    if r.trace is not None:
                        # the step is batch-wide: every traced rider shares
                        # the same start/end stamps
                        r.trace.add("jit-step-start", t=t_step0,
                                    backend=self.backend)
                        r.trace.add("jit-step-end", t=t_step1)
                for i, r in enumerate(batch.requests):
                    if r.future.set_running_or_notify_cancel():
                        tadd(r.trace, "complete", pred=int(preds[i]))
                        tfinish(r.trace)
                        r.future.set_result(int(preds[i]))
                    else:
                        tadd(r.trace, "cancelled", at="resolve")
                        tfinish(r.trace)
            except Exception as e:  # noqa: BLE001 — fail the batch's futures,
                # keep the worker alive for the next batch
                for r in batch.requests:
                    tadd(r.trace, "error", detail=str(e))
                    tfinish(r.trace)
                    _fail_future(r.future, e)

    # -- not ported yet -----------------------------------------------------

    def bind_version(self, *args, **kwargs):
        raise NotImplementedError("model versions are not ported yet")

    def swap_to(self, *args, **kwargs):
        raise NotImplementedError("hot-swap is not ported yet")

    # -- public API ---------------------------------------------------------

    def submit(self, iq: np.ndarray, *, deadline_ms: Optional[float] = None,
               priority: str = "realtime", trace=None):
        """Enqueue one (2, L) frame; returns a ``ServeFuture``."""
        deadline = (None if deadline_ms is None
                    else self.batcher.now() + deadline_ms / 1e3)
        owned = False
        if trace is None:
            trace = begin_trace()
            owned = trace is not None
            tadd(trace, "submit", engine=self.name, priority=priority)
        try:
            return self.batcher.submit(iq, deadline=deadline,
                                       priority=priority, trace=trace)
        except (QueueFull, EngineClosed) as e:
            if owned:
                tadd(trace, "reject", reason=type(e).__name__)
                tfinish(trace)
            raise

    def classify(self, iq: np.ndarray, timeout: float = 300.0, *,
                 deadline_ms: Optional[float] = None,
                 priority: str = "realtime") -> np.ndarray:
        """Blocking wrapper: (N, 2, L) -> class ids (N,).  On timeout or a
        failed request the outstanding futures are cancelled first."""
        futures = [self.submit(iq[i], deadline_ms=deadline_ms,
                               priority=priority)
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

    def close(self) -> None:
        """Stop the workers; queued requests fail instead of hanging."""
        self._stop.set()
        self.batcher.close()
        for t in self._threads:
            t.join(timeout=5.0)
        err = RuntimeError("AsyncAMCServeEngine closed before serving "
                           "this request")
        for r in self.batcher.drain():
            tadd(r.trace, "cancelled", at="close")
            tfinish(r.trace)
            _fail_future(r.future, err)

    def __enter__(self) -> "AsyncAMCServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
