"""AMC serving engines: the sync baseline and the async serving tier.

Port of ``repro/serve/engine.py``.  :class:`AsyncAMCServeEngine` queues
requests in the :class:`~repro_torch.serve.batcher.MicroBatcher`, which
flushes them as fixed-shape buckets; a worker thread runs each bucket
through the serving step on the engine's device and resolves the
requests' futures.  :class:`AMCServeEngine` is the synchronous per-chunk
loop: Σ-Δ encoding on the host, the plan's batch on the device.

The serving step is ``iq -> batch_fn(sigma_delta_encode_batch(iq, T))``:
Σ-Δ encoding in torch ops on the device, then the plan's batch — one
launch of the whole-network kernel for ``cuda_fused``, the layer-by-layer
path for the other backends.  It runs eagerly (no ``torch.compile``, no
CUDA graph).  The ``fixed`` backend encodes with the integer Q0.15 front
end instead.

Backend choice, as in the reference: ``backend="auto"`` (the default)
races the candidates of :func:`~repro_torch.serve.autotune.
default_candidates` — on the card ``dense``, ``goap``, ``cuda`` and
``cuda_fused`` — on the largest bucket and pins the winner
(``engine.autotune`` keeps the report); ``backend="per-layer"`` races
them layer by layer and serves the winning assignment (``engine.perlayer``,
``engine.assignment``); any other name binds that backend.

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

Not ported yet, and refused with ``NotImplementedError``: mesh serving,
model versions and hot-swap.
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
from repro_torch.fixed.golden import golden_encode_frames
from repro_torch.models.graph import compile_snn
from repro_torch.models.snn import SNNConfig, sparsify_params
from repro_torch.obs.activity import ActivityObserver
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.trace import begin_trace, tadd, tfinish
from repro_torch.plan import compile_plan
from repro_torch.serve.autotune import (
    AutotuneReport,
    PerLayerAutotuneReport,
    autotune_backend,
    autotune_per_layer,
    default_candidates,
)
from repro_torch.serve.batcher import EngineClosed, MicroBatcher, QueueFull

__all__ = ["AMCServeEngine", "AsyncAMCServeEngine", "ServeStats",
           "count_batch_activity"]


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


def _encoder(assignment):
    """The on-device Σ-Δ encoder a plan assignment serves with: the
    integer Q0.15 front end for the fixed tier, the float one otherwise."""
    return (fixed_encode_batch if assignment_uses_fixed(assignment)
            else sigma_delta_encode_batch)


class AMCServeEngine:
    """Synchronous per-chunk serving loop (the pre-tier baseline).

    Each chunk of ``batch_size`` frames (the tail zero-padded) is Σ-Δ
    encoded on the host in numpy (the integer golden encoder for
    ``fixed``), then runs through the plan's ``preferred_batch()`` on
    ``device``: the card unless ``device="cpu"``.
    """

    def __init__(
        self,
        params,
        cfg: SNNConfig,
        masks=None,
        batch_size: int = 32,
        count_activity: bool = False,
        backend: str = "goap",
        lsq_scales=None,
        quant_bits: int = 16,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.batch_size = batch_size
        self.count_activity = count_activity
        self.backend = backend
        self.program = compile_snn(cfg)
        # the COO form only feeds the activity-counting hooks
        self.sparse = sparsify_params(params, masks) if count_activity else None
        self.stats = ServeStats(backend=backend)
        # artifacts come from the content-addressed plan cache: a restart
        # on unchanged weights rebuilds nothing
        self.plan = compile_plan(self.program, params, masks=masks,
                                 quant_fn=serving_quant_fn(
                                     lsq_scales, quant_bits, assignment=backend),
                                 assignment=backend, device=self.device)
        self._fwd = self.plan.preferred_batch()

    def _encode(self, chunk: np.ndarray) -> np.ndarray:
        """Host-side Σ-Δ encode; the fixed backend gets the integer path."""
        if assignment_uses_fixed(self.backend):
            return np.moveaxis(
                golden_encode_frames(chunk, self.cfg.timesteps), 0, 1)
        return sigma_delta_encode_np(chunk, self.cfg.timesteps)

    def classify(self, iq: np.ndarray) -> np.ndarray:
        """(N, 2, L) raw I/Q -> class ids (N,); batches internally."""
        n = iq.shape[0]
        preds = np.empty((n,), dtype=np.int32)
        t0 = time.perf_counter()
        for s in range(0, n, self.batch_size):
            chunk = iq[s: s + self.batch_size]
            pad = self.batch_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            frames = self._encode(chunk)
            with torch.inference_mode():
                logits = self._fwd(torch.as_tensor(
                    frames, device=self.device)).cpu().numpy()
            n_real = self.batch_size - pad
            preds[s: s + n_real] = logits[:n_real].argmax(-1)
            self.stats.record_batch(self.backend, padded=pad)
            # latency is arrival (the classify call) to chunk completion,
            # as the async tier's enqueue to completion
            self.stats.record_latencies([time.perf_counter() - t0] * n_real)
            if self.count_activity:
                count_batch_activity(self.stats, self.sparse, frames[:n_real],
                                     self.cfg)
        self.stats.requests += n
        self.stats.wall_s += time.perf_counter() - t0
        return preds


class AsyncAMCServeEngine:
    """Serving tier: ``submit`` -> micro-batcher -> worker loops -> futures.

    Usage::

        engine = AsyncAMCServeEngine(params, SNNConfig(), masks,
                                     max_batch=64)   # backend="auto"
        pred = engine.submit(iq_frame).result()   # (2, L) -> class id
        preds = engine.classify(iq_frames)        # (N, 2, L) -> (N,)
        engine.close()

    Runs on the card unless ``device="cpu"`` is given; without a CUDA
    device it raises.  ``backend="auto"`` races ``candidates`` (default:
    :func:`~repro_torch.serve.autotune.default_candidates` for the device)
    on the largest bucket and serves the winner; ``"per-layer"`` races
    them layer by layer and serves the winning assignment through the
    plan's preferred batch (the whole-network kernel when every layer won
    ``cuda_fused``, else layer by layer).  ``activity_gauges`` (default
    on) reports the live Tables I/III gauges where the plan counts in its
    step (``cuda_fused``, ``stream``); ``lsq_scales``/``quant_bits`` serve
    quantized weights; ``count_activity`` adds host-side exact event
    counts to ``stats``.
    """

    def __init__(
        self,
        params,
        cfg: SNNConfig,
        masks=None,
        *,
        backend: str = "auto",
        max_batch: Optional[int] = None,   # default 64 (or buckets[-1])
        max_delay_ms: float = 5.0,
        buckets: Optional[Sequence[int]] = None,
        workers: int = 1,
        max_queue: Optional[int] = None,
        pace_ms: float = 0.0,
        priority_weights=None,
        warmup: bool = True,
        candidates: Optional[Sequence[str]] = None,
        autotune_reps: int = 2,
        version_label: str = "default",
        name: Optional[str] = None,
        device=None,
        mesh=None,
        count_activity: bool = False,
        lsq_scales=None,
        quant_bits: int = 16,
        activity_gauges: bool = True,
    ):
        if mesh is not None:
            raise NotImplementedError("mesh serving is not ported yet")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.name = name if name is not None else "engine"
        self.version_label = version_label
        self.count_activity = count_activity
        self.program = compile_snn(cfg)
        self.sparse = sparsify_params(params, masks) if count_activity else None

        # registry instrumentation: idempotent creates on the process-wide
        # registry, children resolved here, off the hot path
        reg = default_registry()
        eng = self.name
        self._m_requests = reg.counter(
            "repro_serve_requests_total", "Requests served (real frames)",
            ("engine",)).labels(engine=eng)
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

        self.autotune: Optional[AutotuneReport] = None
        self.perlayer: Optional[PerLayerAutotuneReport] = None
        self.assignment: Optional[Dict[str, str]] = None
        assignment = backend   # what the plan binds: a name or a layer map
        if backend == "per-layer":
            self.perlayer = autotune_per_layer(
                self.program, params, self.batcher.max_batch, masks=masks,
                candidates=candidates, reps=autotune_reps, device=self.device)
            self.assignment = assignment = dict(self.perlayer.assignment)
        elif backend == "auto":
            if candidates is None and lsq_scales is not None:
                # quantized serving: the integer `fixed` backend competes
                candidates = default_candidates(quantized=True,
                                                device=self.device)
            # with LSQ state the race's binds carry the fake-quant weights,
            # so the timings measure the quantized step that would serve
            self.autotune = autotune_backend(
                self.program, params,
                (self.batcher.max_batch, ic0, cfg.input_width), masks=masks,
                quant_fn=serving_quant_fn(lsq_scales, quant_bits),
                candidates=candidates, reps=autotune_reps,
                make_fn=lambda b: self._step_of(b.batch, b.backend),
                device=self.device)
            backend = assignment = self.autotune.choice
        # a fresh quant closure per bind: FixedQuantFn for the fixed tier (it
        # calibrates without LSQ state), LSQ fake-quant for the float
        # backends with LSQ state, None without.  The race compiled through
        # the same content-addressed cache, so its winner binds as a hit.
        self.plan = compile_plan(self.program, params, masks=masks,
                                 quant_fn=serving_quant_fn(
                                     lsq_scales, quant_bits,
                                     assignment=assignment),
                                 assignment=assignment, device=self.device)
        self.backend = backend
        self._m_batches = reg.counter(
            "repro_serve_batches_total", "Micro-batches served",
            ("engine", "backend")).labels(engine=eng, backend=backend)
        self._encode = _encoder(assignment)
        self.activity: Optional[ActivityObserver] = None
        if activity_gauges and self.plan.supports_live_counters:
            self.activity = ActivityObserver(self.plan, engine=self.name)
        self._batch_fn = self.plan.preferred_batch()
        self.stats = ServeStats(backend=backend)

        if warmup:  # run every bucket shape once before taking traffic
            for b in self.batcher.buckets:
                self.serve_step(np.zeros((b, ic0, cfg.input_width), np.float32))

        self._lock = threading.Lock()
        self._t_first_enqueue = float("inf")  # start of the serving window
        self._t_started = time.perf_counter()
        self._busy_s = 0.0  # worker seconds spent serving batches
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"amc-serve-worker-{i}")
            for i in range(max(1, workers))
        ]
        for t in self._threads:
            t.start()

    # -- serving step -------------------------------------------------------

    def _step_of(self, batch_fn, assignment):
        """``iq -> batch_fn(encode(iq))`` on the device: the serving step
        of a raced candidate, as the autotuner times it."""
        encode = _encoder(assignment)
        osr = self.cfg.timesteps
        return lambda iq: batch_fn(encode(iq, osr))

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
            t_step0 = time.perf_counter()
            try:
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
            finally:
                with self._lock:
                    self._busy_s += time.perf_counter() - t_step0

    # -- model versions (not ported yet) ------------------------------------

    @property
    def active_version(self) -> str:
        """Label of the version that serves (the only one, so far)."""
        return self.version_label

    def bind_version(self, *args, **kwargs):
        raise NotImplementedError("model versions are not ported yet")

    def swap_to(self, *args, **kwargs):
        raise NotImplementedError("hot-swap is not ported yet")

    # -- fleet-facing signals -----------------------------------------------

    @property
    def n_workers(self) -> int:
        return len(self._threads)

    @property
    def busy_s(self) -> float:
        """Cumulative worker seconds spent serving batches."""
        with self._lock:
            return self._busy_s

    def utilization(self) -> float:
        """Busy fraction of the workers' capacity since construction."""
        elapsed = time.perf_counter() - self._t_started
        if elapsed <= 0:
            return 0.0
        return min(1.0, self.busy_s / (elapsed * self.n_workers))

    def recent_latencies(self, k: int = 256) -> List[float]:
        """The last ``k`` served requests' latencies (seconds), oldest first."""
        with self._lock:
            return list(self.stats.latencies_s[-k:])

    def export_stats(self) -> dict:
        """``stats.summary()`` plus the live queue and admission signals a
        fleet router or autoscaler acts on."""
        s = self.stats.summary()
        s.update({
            "queue_depth": self.batcher.qsize(),
            "queue_depths_by_priority": self.batcher.qsizes(),
            "n_expired": self.batcher.n_expired,
            "n_rejected": self.batcher.n_rejected,
            "n_cancelled": self.batcher.n_cancelled,
            "workers": self.n_workers,
            "busy_s": self.busy_s,
            "utilization": self.utilization(),
            "active_version": self.active_version,
        })
        return s

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
