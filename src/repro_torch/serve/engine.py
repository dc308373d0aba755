"""Async AMC serving engine: queue -> micro-batcher -> worker loops.

Port of ``AsyncAMCServeEngine`` and ``ServeStats`` from
``repro/serve/engine.py``.  Requests queue in the
:class:`~repro_torch.serve.batcher.MicroBatcher`, which flushes them as
fixed-shape buckets; a worker thread runs each bucket through the serving
step on the engine's device and resolves the requests' futures.

The serving step is ``iq -> plan.preferred_batch()(sigma_delta_encode_batch(
iq, T))``: Σ-Δ encoding in torch ops on the device, then — for the default
``cuda_fused`` backend — one launch of the whole-network kernel.  It runs
eagerly (no ``torch.compile``, no CUDA graph).  The ``fixed`` backend
encodes with the integer Q0.15 front end instead.

Live activity gauges (``activity_gauges=True``, the default): when the
plan's conv layers count in their step (``cuda_fused`` or ``stream``),
the step is ``plan.batch_counters``; logits and the per-conv gated
accumulation counts come to the host in one copy, and the real rows of
each batch feed :class:`~repro_torch.obs.activity.ActivityObserver`
(the Tables I/III gauges).  Every batch is also mirrored into the
process-wide metrics registry (``repro_serve_*``), as in the reference.

``lsq_scales`` / ``quant_bits`` serve fake-quantized weights (the float
backends) or integer codes (``fixed``) through the same bind path;
``count_activity`` is the reference's host diagnostics mode (exact
Table I/III event counts per real frame, on the CPU, outside the step).

Not ported yet, and refused with ``NotImplementedError``: ``backend="auto"``
and ``"per-layer"`` (autotuning), mesh serving, model versions and
hot-swap.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cost_model import bits_fetched, fc_wm_counts, goap_conv_counts
from repro_torch.core.saocds import max_pool_spikes, pad_same, saocds_conv_layer
from repro_torch.core.sparse_format import weight_mask_from_dense
from repro_torch.data.pipeline import sigma_delta_encode_batch, sigma_delta_encode_np
from repro_torch.device import resolve_device
from repro_torch.fixed import assignment_uses_fixed, fixed_encode_batch, serving_quant_fn
from repro_torch.models.graph import compile_snn
from repro_torch.models.snn import SNNConfig, sparsify_params
from repro_torch.obs.activity import ActivityObserver
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.trace import begin_trace, tadd, tfinish
from repro_torch.plan import compile_plan
from repro_torch.serve.batcher import EngineClosed, MicroBatcher, QueueFull

__all__ = ["AsyncAMCServeEngine", "ServeStats", "count_batch_activity"]


@dataclasses.dataclass
class ServeStats:
    # histories are bounded: percentiles/means cover the newest MAX_SAMPLES
    MAX_SAMPLES = 65536

    requests: int = 0
    batches: int = 0
    accumulations: int = 0
    fetched_bits: int = 0
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
            "accumulations": self.accumulations,
            "fetched_bits": self.fetched_bits,
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


def count_batch_activity(stats: ServeStats, sparse, frames: np.ndarray,
                         cfg: SNNConfig) -> None:
    """Exact event counts through the conv stack (cost-model hooks), on
    the host.

    ``frames``: (B, T, IC, L) encoded spikes, **real rows only** — the
    caller strips the padded tail so padding never reaches the stats.
    ``sparse`` is ``sparsify_params`` output; the counting runs on the CPU.
    """
    # the WM layout depends only on the fixed weights (counting the
    # dominant FC is enough)
    wm = weight_mask_from_dense(sparse["fc"][0]["w"].detach().cpu().numpy())
    with torch.inference_mode():
        for b in range(frames.shape[0]):
            x = torch.as_tensor(frames[b], dtype=torch.float32)  # (T, IC, L)
            for layer in sparse["conv"]:
                coo = layer["coo"]
                padded = pad_same(x, coo.kw)
                c = goap_conv_counts(padded.numpy(), coo)
                stats.accumulations += c.accumulations
                stats.fetched_bits += bits_fetched(c)
                # advance the stream (vectorized emulation for counting)
                out, _ = saocds_conv_layer(padded, coo, layer["lif"].to("cpu"))
                x = max_pool_spikes(out, cfg.pool)
            c = fc_wm_counts(x.reshape(x.shape[0], -1).numpy(), wm)
            stats.accumulations += c.accumulations
            stats.fetched_bits += bits_fetched(c)


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
    device it raises.  ``activity_gauges`` (default on) reports the live
    Tables I/III gauges where the backend counts in its step
    (``cuda_fused``, ``stream``); ``lsq_scales``/``quant_bits`` serve
    quantized weights; ``count_activity`` adds host-side exact event
    counts to ``stats``.
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
        quant_bits: int = 16,
        activity_gauges: bool = True,
    ):
        if backend in _WAITING:
            raise NotImplementedError(f"backend={backend!r} (autotuning) is "
                                      "not ported yet; name a backend")
        if mesh is not None:
            raise NotImplementedError("mesh serving is not ported yet")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.name = name if name is not None else "engine"
        self.backend = backend
        self.count_activity = count_activity
        self.program = compile_snn(cfg)
        self.sparse = sparsify_params(params, masks) if count_activity else None
        # a fresh quant closure per bind: FixedQuantFn for the fixed tier
        # (it calibrates without LSQ state), LSQ fake-quant for the float
        # backends with LSQ state, None without
        self.plan = compile_plan(self.program, params, masks=masks,
                                 quant_fn=serving_quant_fn(
                                     lsq_scales, quant_bits, assignment=backend),
                                 assignment=backend, device=self.device)
        self._encode = (fixed_encode_batch if assignment_uses_fixed(backend)
                        else sigma_delta_encode_batch)
        self.activity: Optional[ActivityObserver] = None
        if activity_gauges and self.plan.supports_live_counters:
            self.activity = ActivityObserver(self.plan, engine=self.name)
        self._batch_fn = self.plan.preferred_batch()

        # registry instrumentation: idempotent creates on the process-wide
        # registry, children resolved here, off the hot path
        reg = default_registry()
        eng = self.name
        self._m_requests = reg.counter(
            "repro_serve_requests_total", "Requests served (real frames)",
            ("engine",)).labels(engine=eng)
        self._m_batches = reg.counter(
            "repro_serve_batches_total", "Micro-batches served",
            ("engine", "backend")).labels(engine=eng, backend=backend)
        self._m_padded = reg.counter(
            "repro_serve_padded_frames_total",
            "Zero-padded tail rows shipped in fixed-shape buckets",
            ("engine",)).labels(engine=eng)
        self._m_latency = reg.histogram(
            "repro_serve_request_latency_seconds",
            "Per-request enqueue-to-completion latency",
            ("engine",)).labels(engine=eng)
        self._m_qdepth = reg.gauge(
            "repro_serve_queue_depth",
            "Queue backlog observed at the last batch flush",
            ("engine",)).labels(engine=eng)
        obs_counters = {
            "expired": reg.counter(
                "repro_serve_expired_total",
                "Requests failed fast on a passed deadline",
                ("engine",)).labels(engine=eng),
            "rejected": reg.counter(
                "repro_serve_rejected_total",
                "Submits refused by the max_queue admission bound",
                ("engine",)).labels(engine=eng),
            "cancelled": reg.counter(
                "repro_serve_cancelled_total",
                "Cancelled futures dropped without a batch slot",
                ("engine",)).labels(engine=eng),
        }

        ic0 = cfg.conv_specs[0][1]
        self.batcher = MicroBatcher(
            frame_shape=(ic0, cfg.input_width), max_batch=max_batch,
            max_delay_ms=max_delay_ms, buckets=buckets, max_queue=max_queue,
            pace_ms=pace_ms, priority_weights=priority_weights,
            obs_counters=obs_counters)
        self.stats = ServeStats(backend=backend)

        if warmup:  # run every bucket shape once before taking traffic
            for b in self.batcher.buckets:
                self.serve_step(np.zeros((b, ic0, cfg.input_width), np.float32))

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

    def serve_step(self, iq: np.ndarray):
        """The served step: (B, IC, L) raw I/Q -> ((B, n_classes) logits,
        {conv_name: (B,) accumulations} or None), both on the host.

        With gauges on, logits and counters leave the device in one copy.
        """
        with torch.inference_mode():
            x = torch.as_tensor(iq, dtype=torch.float32, device=self.device)
            frames = self._encode(x, self.cfg.timesteps)
            if self.activity is None:
                return self._batch_fn(frames).cpu().numpy(), None
            logits, accs = self.plan.batch_counters(frames)
            names = list(accs)
            packed = torch.cat([logits] + [accs[n][:, None] for n in names],
                               dim=1)
            host = packed.cpu().numpy()
        n_classes = logits.shape[1]
        return host[:, :n_classes], {n: host[:, n_classes + i]
                                     for i, n in enumerate(names)}

    def step(self, iq: np.ndarray) -> np.ndarray:
        """(B, IC, L) raw I/Q -> (B, n_classes) logits, on the host."""
        return self.serve_step(iq)[0]

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
                logits, accs = self.serve_step(batch.frames)
                t_step1 = time.perf_counter()
                preds = logits.argmax(-1).astype(np.int32)
                n_real = batch.n_real
                if accs is not None:   # padded tail rows never counted
                    self.activity.observe(accs, n_real)
                # the diagnostics mode runs before the futures resolve, so
                # a caller reading ``stats`` after its results sees them
                counted: Optional[ServeStats] = None
                if self.count_activity:
                    counted = ServeStats()
                    frames = sigma_delta_encode_np(batch.frames[:n_real],
                                                   self.cfg.timesteps)
                    count_batch_activity(counted, self.sparse, frames,
                                         self.cfg)
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
                    if counted is not None:
                        st.accumulations += counted.accumulations
                        st.fetched_bits += counted.fetched_bits
                # registry mirrors (family-locked; outside the engine lock)
                self._m_requests.inc(n_real)
                self._m_batches.inc()
                self._m_padded.inc(batch.n_padded)
                self._m_qdepth.set(batch.queue_depth)
                for r in batch.requests:
                    self._m_latency.observe(t_done - r.t_enqueue)
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
