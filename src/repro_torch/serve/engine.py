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
path for the other backends.  The ``fixed`` backend encodes with the
integer Q0.15 front end instead.  On the card the async engine serves the
step by CUDA-graph replay, one graph per batch shape, captured at warm-up
or at a shape's first use (:mod:`repro_torch.serve.capture`, the port of
the reference's ``jax.jit``); the backend race times each candidate
through the captured step it would serve with, and the engine serves the
winner's graphs.  On the CPU the step runs eagerly.

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

Model versions (the deploy subsystem's hooks): the async engine serves
from a label -> :class:`BoundVersion` table.  The primary label takes all
traffic unless a router (canary / A/B split) is installed;
:meth:`~AsyncAMCServeEngine.bind_version` binds a new version off the hot
path and :meth:`~AsyncAMCServeEngine.swap_to` flips the primary between
micro-batches, each batch pinned to the version that started it.

Mesh serving (the reference's ``shard_map`` step): with ``mesh=`` (a
:func:`~repro_torch.distributed.sharding.serve_mesh`), or by default when
more than one card is present and no ``device`` is given, every bucket is
aligned to the mesh's ``data`` size and each batch is split evenly over
its devices.  Each device has its own plan and, on the card, its own
captured graphs, for every bound version; a served step copies every
shard in, replays every device's graph and copies every output out before
it waits on each device once.  The race times that sharded step.  Live
activity gauges are off under a mesh, as in the reference.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cost_model import bits_fetched, fc_wm_counts, goap_conv_counts
from repro_torch.core.saocds import max_pool_spikes, pad_same, saocds_conv_layer
from repro_torch.core.sparse_format import weight_mask_from_dense
from repro_torch.data.pipeline import sigma_delta_encode_batch, sigma_delta_encode_np
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import ServeMesh, serve_mesh, shard_serve_fn
from repro_torch.fixed import assignment_uses_fixed, fixed_encode_batch, serving_quant_fn
from repro_torch.fixed.golden import golden_encode_frames
from repro_torch.models.graph import compile_snn, weight_values
from repro_torch.models.snn import SNNConfig, sparsify_params
from repro_torch.obs.activity import ActivityObserver
from repro_torch.obs.metrics import default_registry
from repro_torch.obs.trace import begin_trace, span, tadd, tfinish
from repro_torch.plan import compile_plan
from repro_torch.serve.autotune import (
    AutotuneReport,
    PerLayerAutotuneReport,
    autotune_backend,
    autotune_per_layer,
    default_candidates,
)
from repro_torch.serve.batcher import EngineClosed, MicroBatcher, QueueFull
from repro_torch.serve.capture import CapturedStep, captures

__all__ = ["AMCServeEngine", "AsyncAMCServeEngine", "BoundVersion",
           "ServeStats", "count_batch_activity"]


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


def host_logits(logits: torch.Tensor) -> torch.Tensor:
    """Logits as the host receives them: bf16 widened to f32 on the device
    (numpy holds no bf16; the values are exact), other dtypes as they are
    (the ``fixed`` tier's int32)."""
    return logits.float() if logits.dtype == torch.bfloat16 else logits


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
    wm = weight_mask_from_dense(weight_values(sparse["fc"][0]["w"]))
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
                logits = host_logits(self._fwd(torch.as_tensor(
                    frames, device=self.device))).cpu().numpy()
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


@dataclasses.dataclass
class BoundVersion:
    """One bound model version in the async engine's serving table.

    Each version carries its own plan, serving step and
    :class:`ServeStats`, so a canary's latency and accuracy are observable
    apart from the production baseline's.  ``serve_step`` maps (B, IC, L)
    raw I/Q (numpy) to ``(logits, {conv_name: (B,) accumulations} or
    None)`` on the host; :meth:`step` keeps the logits.
    """

    label: str
    backend: str
    serve_step: Callable = dataclasses.field(repr=False)
    plan: Any = dataclasses.field(repr=False)
    sparse: Any = dataclasses.field(default=None, repr=False)
    stats: ServeStats = dataclasses.field(default_factory=ServeStats)
    # start of *this version's* serving window (earliest enqueue among the
    # requests it served): a late-bound canary's wall_s is not diluted by
    # traffic that predates its bind
    t_first: float = float("inf")
    # live gauges: the ActivityObserver that the step's counters feed, or
    # None when the step returns bare logits
    activity: Optional[ActivityObserver] = dataclasses.field(default=None,
                                                             repr=False)
    # the step's CUDA graphs, or None where it runs eagerly
    graphs: Optional[CapturedStep] = dataclasses.field(default=None,
                                                       repr=False)

    def step(self, iq: np.ndarray) -> np.ndarray:
        """(B, IC, L) raw I/Q -> (B, n_classes) logits, on the host."""
        return self.serve_step(iq)[0]

    def release(self) -> None:
        """Free the step's CUDA graphs (a later step captures anew)."""
        if self.graphs is not None:
            self.graphs.release()


class AsyncAMCServeEngine:
    """Serving tier: ``submit`` -> micro-batcher -> worker loops -> futures.

    Usage::

        engine = AsyncAMCServeEngine(params, SNNConfig(), masks,
                                     max_batch=64)   # backend="auto"
        pred = engine.submit(iq_frame).result()   # (2, L) -> class id
        preds = engine.classify(iq_frames)        # (N, 2, L) -> (N,)
        engine.close()

    Runs on the card unless ``device="cpu"`` is given; without a CUDA
    device it raises.  ``mesh`` (default: every card, when more than one is
    present and ``device`` is None) shards each batch over a serving mesh.
    ``backend="auto"`` races ``candidates`` (default:
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
        if mesh is None and device is None and torch.cuda.device_count() > 1:
            mesh = serve_mesh()
        if mesh is not None:
            if not isinstance(mesh, ServeMesh):
                raise TypeError(f"mesh must be a ServeMesh (repro_torch."
                                f"distributed.sharding.serve_mesh()), not "
                                f"{type(mesh).__name__}")
            if device is not None and resolve_device(device) != mesh.devices[0]:
                raise ValueError(f"device {device!r} is not the first device "
                                 f"of the mesh {mesh}")
            self.device = mesh.devices[0]
        else:
            self.device = resolve_device(device)
        self.mesh = mesh
        self.devices = list(mesh.devices) if mesh is not None else [self.device]
        self.cfg = cfg
        self.name = name if name is not None else "engine"
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
            obs_counters=obs_counters, align=len(self.devices))

        self._candidates = candidates
        self._autotune_reps = autotune_reps
        self.activity_gauges = activity_gauges
        # the step's counters ride beside the logits only without a mesh
        self._counters_wanted = activity_gauges and mesh is None
        self.autotune: Optional[AutotuneReport] = None
        self.perlayer: Optional[PerLayerAutotuneReport] = None
        self.assignment: Optional[Dict[str, str]] = None
        assignment = backend   # what the plan binds: a name or a layer map
        raced: Dict[str, Any] = {}
        if backend == "per-layer":
            self.perlayer = autotune_per_layer(
                self.program, params, self.batcher.max_batch, masks=masks,
                candidates=candidates, reps=autotune_reps, device=self.device)
            self.assignment = assignment = dict(self.perlayer.assignment)
        elif backend == "auto":
            self.autotune, raced = self._race(params, masks, lsq_scales,
                                              quant_bits)
            backend = assignment = self.autotune.choice
        # a fresh quant closure per bind: FixedQuantFn for the fixed tier (it
        # calibrates without LSQ state), LSQ fake-quant for the float
        # backends with LSQ state, None without.  The race compiled through
        # the same content-addressed cache, so its winner binds as a hit.
        plans = self._plans(params, masks, lambda: serving_quant_fn(
            lsq_scales, quant_bits, assignment=assignment), assignment)
        plan = plans[0]
        self.backend = backend
        self.quant_bits = quant_bits
        self._m_batches = reg.counter(
            "repro_serve_batches_total", "Micro-batches served",
            ("engine", "backend"))
        self.stats = ServeStats(backend=backend)
        self._lock = threading.Lock()

        # serving table: label -> BoundVersion.  The primary takes all
        # traffic unless a router is installed (deploy.router); a hot-swap
        # (deploy.swap) binds a new version off-thread, then flips _primary
        # between micro-batches.
        first = self._bound(version_label, backend, plans, assignment,
                            self.sparse,
                            step=self._raced_step(raced, backend, plan))
        # readiness: set by the primary's warm-up (its graphs captured) or
        # by the first successful step; what /readyz keys on
        self._ready = threading.Event()
        if warmup:  # run every bucket shape once before taking traffic
            self._warm(first)
            self._ready.set()
        self._versions: Dict[str, BoundVersion] = {version_label: first}
        self._primary = version_label
        self._router: Optional[Callable[[], str]] = None
        self.plan = plan
        self.activity = first.activity

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

    def _plans(self, params, masks, quant_fn, assignment, first=None):
        """One plan of ``assignment`` per serving device (one without a
        mesh), each compiled with a fresh ``quant_fn()``; ``first``, where
        given, is the first device's."""
        return [first if i == 0 and first is not None else compile_plan(
            self.program, params, masks=masks, quant_fn=quant_fn(),
            assignment=assignment, device=dev)
            for i, dev in enumerate(self.devices)]

    def _race(self, params, masks, lsq_scales, quant_bits):
        """The whole-network race of the engine's candidates on the largest
        bucket, each timed through the served step it would serve with
        (captured on the card, sharded over the mesh): ``(report, {backend:
        (plan digest, step)})`` so that the winner's step, graphs and all,
        can serve."""
        candidates = self._candidates
        if candidates is None and lsq_scales is not None:
            # quantized serving: the integer `fixed` backend competes
            candidates = default_candidates(quantized=True, device=self.device)
        ic0 = self.cfg.conv_specs[0][1]
        shape = (self.batcher.max_batch, ic0, self.cfg.input_width)
        # the race's all-zero probe, handed to each step from the host as a
        # served batch is
        probe = np.zeros(shape, np.float32)
        raced: Dict[str, Any] = {}

        def make_fn(binding):
            plans = self._plans(params, masks, lambda: serving_quant_fn(
                lsq_scales, quant_bits), binding.backend, first=binding.plan)
            step = self._make_step(plans, binding.backend)
            raced[binding.backend] = (binding.plan.digest, step)
            return lambda _: step[0](probe)

        # with LSQ state the race's binds carry the fake-quant weights, so
        # the timings measure the quantized step that would serve
        report = autotune_backend(
            self.program, params, shape, masks=masks,
            quant_fn=serving_quant_fn(lsq_scales, quant_bits),
            candidates=candidates, reps=self._autotune_reps,
            make_fn=make_fn, device=self.device)
        return report, raced

    @staticmethod
    def _raced_step(raced: Dict[str, Any], backend: str, plan):
        """The race winner's step where it serves ``plan`` (the same
        content), reused as the reference reuses the winner's compile;
        every other candidate's graphs are freed."""
        keep = None
        for name, (digest, step) in raced.items():
            if name == backend and digest == plan.digest:
                keep = step
            elif step[1] is not None:
                step[1].release()
        return keep

    def _make_step(self, plans, assignment):
        """``(serve_step, graphs)`` for ``plans`` (one per serving device):
        Σ-Δ encode on the device (the integer front end for the fixed tier),
        then the plan's preferred batch; with live gauges, where the plan
        counts in its step, ``plan.batch_counters`` with its counters packed
        beside the logits, so both leave the device in one copy.
        ``serve_step`` maps (B, IC, L) raw I/Q (numpy) to ``(logits,
        {conv_name: (B,) accumulations} or None)`` on the host; on the card
        it replays ``graphs``, one CUDA graph per batch shape and device,
        and under a mesh each device serves its slice of the batch."""
        encode = _encoder(assignment)
        osr = self.cfg.timesteps
        counters = self._counters_wanted and plans[0].supports_live_counters
        layout = {"names": [], "n_classes": 0}

        def forward_of(plan):
            if counters:
                def forward(x: torch.Tensor) -> torch.Tensor:
                    logits, accs = plan.batch_counters(encode(x, osr))
                    layout["names"] = list(accs)
                    layout["n_classes"] = logits.shape[1]
                    return torch.cat([host_logits(logits)] + [accs[n][:, None]
                                                 for n in layout["names"]],
                                     dim=1)
                return forward
            batch_fn = plan.preferred_batch()
            return lambda x: host_logits(batch_fn(encode(x, osr)))

        forwards = [forward_of(plan) for plan in plans]
        graphs = CapturedStep(forwards, self.devices) if captures(
            assignment, self.device) else None
        eager = shard_serve_fn(forwards, ServeMesh(self.devices))

        def run(iq: np.ndarray) -> np.ndarray:
            if graphs is not None:
                return graphs(iq)
            with span("step.eager"), torch.inference_mode():
                return eager(np.asarray(iq, np.float32)).numpy()

        def serve_step(iq: np.ndarray):
            host = run(iq)
            if not counters:
                return host, None
            with span("step.unpack"):
                n = layout["n_classes"]
                return host[:, :n], {name: host[:, n + i]
                                     for i, name in enumerate(layout["names"])}

        return serve_step, graphs

    def _bound(self, label: str, backend: str, plans, assignment,
               sparse, step=None) -> BoundVersion:
        """A :class:`BoundVersion` serving ``plans`` (one per serving
        device) through ``step`` (a ``(serve_step, graphs)`` pair; by
        default a new :meth:`_make_step`)."""
        plan = plans[0]
        serve_step, graphs = (step if step is not None
                              else self._make_step(plans, assignment))
        activity = (ActivityObserver(plan, engine=self.name)
                    if self._counters_wanted and plan.supports_live_counters
                    else None)
        return BoundVersion(label=label, backend=backend,
                            serve_step=serve_step, plan=plan, sparse=sparse,
                            stats=ServeStats(backend=backend),
                            activity=activity, graphs=graphs)

    def _warm(self, ver: BoundVersion) -> None:
        """Run every bucket shape once (on the card: capture its graph and
        replay it), ending in a synchronise."""
        ic0 = self.cfg.conv_specs[0][1]
        for b in self.batcher.buckets:
            ver.serve_step(np.zeros((b, ic0, self.cfg.input_width), np.float32))

    def serve_step(self, iq: np.ndarray):
        """The primary version's served step: (B, IC, L) raw I/Q ->
        ((B, n_classes) logits, {conv_name: (B,) accumulations} or None),
        both on the host.  With gauges on, logits and counters leave the
        device in one copy."""
        with self._lock:
            ver = self._versions[self._primary]
        return ver.serve_step(iq)

    def step(self, iq: np.ndarray) -> np.ndarray:
        """(B, IC, L) raw I/Q -> (B, n_classes) logits, on the host."""
        return self.serve_step(iq)[0]

    # -- worker loop --------------------------------------------------------

    def _route(self) -> BoundVersion:
        """The version serving the next batch (the router's pick, else the
        primary).  A router naming a removed label, or one that raises,
        degrades to the primary: routing never takes the worker down.  The
        table is read under the engine lock, so it never interleaves with a
        swap_to / remove_version pair."""
        label: Optional[str] = None
        router = self._router
        if router is not None:
            try:
                label = router()
            except Exception:  # noqa: BLE001 — a broken router must not
                label = None   # take the serving loop down with it
        with self._lock:
            ver = self._versions.get(label) if label is not None else None
            return ver if ver is not None else self._versions[self._primary]

    def _worker(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            batch = self.batcher.get_batch(timeout=0.1)
            if batch is None:
                continue
            t_busy0 = time.perf_counter()
            try:
                # the version is pinned per batch: a hot-swap flipping the
                # primary mid-service never retargets an in-flight batch.
                # Routing runs inside the covered block, so a failure fails
                # the batch's futures instead of stranding them.
                ver = self._route()
                t_step0 = time.perf_counter()
                with span("engine.step"):
                    logits, accs = ver.serve_step(batch.frames)
                t_step1 = time.perf_counter()
                with span("engine.resolve"):
                    self._resolve(batch, ver, logits, accs, t_step0, t_step1)
            except Exception as e:  # noqa: BLE001 — fail the batch's futures,
                # keep the worker alive for the next batch
                for r in batch.requests:
                    tadd(r.trace, "error", detail=str(e))
                    tfinish(r.trace)
                    _fail_future(r.future, e)
            finally:
                with self._lock:
                    self._busy_s += time.perf_counter() - t_busy0

    def _resolve(self, batch, ver: BoundVersion, logits: np.ndarray, accs,
                 t_step0: float, t_step1: float) -> None:
        """After a batch's step: its predictions, the gauges, the stats and
        registry mirrors, the traces, then each request's future."""
        self._ready.set()   # the first successful step: /readyz 200
        preds = logits.argmax(-1).astype(np.int32)
        n_real = batch.n_real
        if accs is not None:   # padded tail rows never counted
            ver.activity.observe(accs, n_real)
        # the diagnostics mode runs before the futures resolve, so
        # a caller reading ``stats`` after its results sees them
        counted: Optional[ServeStats] = None
        if self.count_activity and ver.sparse is not None:
            counted = ServeStats()
            frames = sigma_delta_encode_np(batch.frames[:n_real],
                                           self.cfg.timesteps)
            count_batch_activity(counted, ver.sparse, frames, self.cfg)
        t_done = time.perf_counter()
        with self._lock:
            # serving windows: the engine's from its first enqueue,
            # the version's from the first request it served
            batch_first = min(r.t_enqueue for r in batch.requests)
            self._t_first_enqueue = min(self._t_first_enqueue, batch_first)
            ver.t_first = min(ver.t_first, batch_first)
            for st, t0 in ((self.stats, self._t_first_enqueue),
                           (ver.stats, ver.t_first)):
                st.requests += n_real
                st.record_batch(ver.backend, queue_depth=batch.queue_depth,
                                padded=batch.n_padded)
                st.record_latencies(t_done - r.t_enqueue
                                    for r in batch.requests)
                st.wall_s = max(st.wall_s, t_done - t0)
                if counted is not None:
                    st.accumulations += counted.accumulations
                    st.fetched_bits += counted.fetched_bits
        # registry mirrors (family-locked; outside the engine lock)
        self._m_requests.inc(n_real)
        self._m_batches.labels(engine=self.name, backend=ver.backend).inc()
        self._m_padded.inc(batch.n_padded)
        self._m_qdepth.set(batch.queue_depth)
        for r in batch.requests:
            self._m_latency.observe(t_done - r.t_enqueue)
            if r.trace is not None:
                # the step is batch-wide: every traced rider shares
                # the same start/end stamps
                r.trace.add("jit-step-start", t=t_step0,
                            version=ver.label, backend=ver.backend)
                r.trace.add("jit-step-end", t=t_step1)
        for i, r in enumerate(batch.requests):
            if r.future.set_running_or_notify_cancel():
                tadd(r.trace, "complete", pred=int(preds[i]))
                tfinish(r.trace)
                r.future.set_result(int(preds[i]))
            else:
                tadd(r.trace, "cancelled", at="resolve")
                tfinish(r.trace)

    # -- model lifecycle (the deploy subsystem's hooks) ---------------------

    @property
    def active_version(self) -> str:
        """Label of the primary (default-traffic) version."""
        return self._primary

    def versions(self) -> Dict[str, BoundVersion]:
        """Snapshot of the serving table (label -> BoundVersion)."""
        with self._lock:
            return dict(self._versions)

    def get_version(self, label: str) -> BoundVersion:
        with self._lock:
            return self._versions[label]

    def version_stats(self) -> Dict[str, ServeStats]:
        with self._lock:
            return {k: v.stats for k, v in self._versions.items()}

    def bind_version(self, label: str, params, masks=None, *,
                     backend: Optional[str] = None, lsq_scales=None,
                     quant_bits: Optional[int] = None,
                     warmup: bool = True) -> BoundVersion:
        """Compile and register a new model version under ``label``.

        Safe while serving: the plan bind and the per-bucket warm-up run in
        the caller's thread (the plan cache is content-addressed), and only
        the table insert takes the engine lock, so the workers keep serving
        the current versions.  The new version takes no traffic until
        :meth:`swap_to` or a router targets it.

        ``backend=None`` inherits the engine's serving backend (including
        a ``per-layer`` assignment); ``backend="auto"`` races the engine's
        candidates on the new weights.  Nothing here falls back: on the
        card a kernel backend that fails to bind or launch raises.
        """
        if backend is None:
            backend = self.backend
        bits = quant_bits if quant_bits is not None else self.quant_bits
        raced: Dict[str, Any] = {}
        if backend == "per-layer":
            if not self.assignment:
                # serving a uniform backend while reporting "per-layer"
                # would misstate what runs: the layer race only exists on
                # engines constructed with it
                raise ValueError(
                    "backend='per-layer' requires an engine constructed "
                    "with backend='per-layer' (no autotuned assignment to "
                    "inherit); pass an explicit backend instead")
            assignment = dict(self.assignment)
        else:
            if backend == "auto":
                report, raced = self._race(params, masks, lsq_scales, bits)
                backend = report.choice
            assignment = backend
        plans = self._plans(params, masks, lambda: serving_quant_fn(
            lsq_scales, bits, assignment=assignment), assignment)
        sparse = (sparsify_params(params, masks) if self.count_activity
                  else None)
        ver = self._bound(label, backend, plans, assignment, sparse,
                          step=self._raced_step(raced, backend, plans[0]))
        if warmup:  # every bucket once, so the flip never stalls
            self._warm(ver)
        with self._lock:
            self._versions[label] = ver
        return ver

    def swap_to(self, label: str) -> str:
        """Atomically make ``label`` the primary version; returns the old.

        A table-pointer update between micro-batches: in-flight batches
        complete on the version that started them, and the next batch any
        worker picks up serves from the new primary.
        """
        with self._lock:
            if label not in self._versions:
                raise KeyError(
                    f"no bound version {label!r} (bound: "
                    f"{sorted(self._versions)})")
            old, self._primary = self._primary, label
            ver = self._versions[label]
            self.backend = ver.backend
            self.plan = ver.plan
            self.activity = ver.activity
            self.stats.backend = ver.backend
        return old

    def remove_version(self, label: str) -> None:
        """Drop a non-primary version from the serving table."""
        with self._lock:
            if label == self._primary:
                raise ValueError(
                    f"cannot remove the primary version {label!r}; "
                    "swap_to another version first")
            ver = self._versions.pop(label, None)
        if ver is not None:
            ver.release()

    def set_router(self, router: Optional[Callable[[], str]]) -> None:
        """Install (or clear, with None) the per-batch version router."""
        self._router = router

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

    def is_ready(self) -> bool:
        """True once the primary's warm-up or the first step succeeded,
        until :meth:`close`."""
        return self._ready.is_set() and not self._stop.is_set()

    @property
    def closed(self) -> bool:
        return self._stop.is_set()

    def close(self) -> None:
        """Stop the workers; queued requests fail instead of hanging.  The
        versions' CUDA graphs are freed (a later ``step`` captures anew)."""
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
        for ver in self.versions().values():
            ver.release()

    def __enter__(self) -> "AsyncAMCServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
