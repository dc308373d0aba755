"""Zero-downtime hot-swap for :class:`AsyncAMCServeEngine`.

Port of ``repro/deploy/swap.py``; bind and flip durations and swap
outcomes go to the port's metrics registry (:mod:`repro_torch.obs.metrics`).

The sequence mirrors a blue/green flip collapsed into one process:

1. **bind off the hot path** — the incoming version's plan is compiled in
   the swapping thread (``compile_plan`` through the content-addressed
   cache — a registry publish already warmed the COO/schedule artifacts)
   and every micro-batch bucket shape runs once, while the workers keep
   draining traffic on the current version;
2. **atomic flip** — ``engine.swap_to`` retargets the primary label
   between micro-batches: in-flight batches complete on the old plan,
   the next batch any worker picks up runs the new one.  No request is
   dropped, and none waits for more than one batch flush;
3. **drain barrier** — ``batcher.drain_barrier`` confirms every request
   enqueued before the flip has been batched, which is what the
   :class:`SwapReport` certifies.

``hot_swap`` blocks; ``hot_swap_async`` runs the same sequence on a
daemon thread and returns a ``concurrent.futures.Future[SwapReport]`` —
the pattern a control plane (or the canary monitor's promote path) uses.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
import time
from typing import Any, Dict, Optional

from repro_torch.deploy.registry import ModelRegistry
from repro_torch.obs.metrics import default_registry

__all__ = ["SwapReport", "hot_swap", "hot_swap_async",
           "hot_swap_from_registry", "mark_production"]

#: Histogram bounds for bind/flip durations (seconds): swaps are rare,
#: seconds-scale events, so the default latency ladder is too fine.
_SWAP_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def mark_production(label: str) -> None:
    """Flag ``label`` as the production version in the metrics registry.

    Prometheus "info" pattern: the gauge family
    ``repro_deploy_production_info{version=...}`` holds exactly one child
    at 1 (all previously-marked versions drop to 0), so a scrape joins
    metrics against the serving version without a registry reset.
    """
    default_registry().gauge(
        "repro_deploy_production_info",
        "1 on the label currently marked production, 0 on prior labels",
        ("version",)).set_exclusive(version=label)


@dataclasses.dataclass(frozen=True)
class SwapReport:
    """What a completed hot-swap certifies (and what the bench records)."""

    old_label: str
    new_label: str
    backend: str
    bind_s: float          # off-thread plan bind + per-bucket warm-up
    flip_s: float          # swap_to() -> pre-flip backlog fully batched
    queued_at_flip: int    # requests waiting in the queue at the flip
    drained: bool          # pre-flip backlog confirmed batched in time
    plan_digest: Optional[str]

    def summary(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def hot_swap(
    engine,
    params,
    masks=None,
    *,
    label: str,
    backend: Optional[str] = None,
    lsq_scales=None,
    quant_bits: Optional[int] = None,
    warmup: bool = True,
    drain_timeout: float = 30.0,
) -> SwapReport:
    """Bind ``params`` under ``label`` and flip the engine's primary to it.

    Safe under live traffic: the bind runs in this thread, the flip is a
    table-pointer update, and the drain barrier bounds how long the old
    plan's backlog lingers.  Raises if ``label`` is already bound (each
    version label is immutable once serving — publish a new version
    instead of mutating one in place).
    """
    if label in engine.versions():
        raise ValueError(f"version label {label!r} is already bound")
    t0 = time.perf_counter()
    ver = engine.bind_version(label, params, masks, backend=backend,
                              lsq_scales=lsq_scales, quant_bits=quant_bits,
                              warmup=warmup)
    bind_s = time.perf_counter() - t0

    queued = engine.batcher.qsize()
    t1 = time.perf_counter()
    old = engine.swap_to(label)
    drained = engine.batcher.drain_barrier(timeout=drain_timeout)
    flip_s = time.perf_counter() - t1
    reg = default_registry()
    reg.counter("repro_deploy_swaps_total", "Completed hot-swaps by outcome",
                ("outcome",)).labels(
        outcome="drained" if drained else "drain-timeout").inc()
    reg.histogram("repro_deploy_bind_seconds",
                  "Off-hot-path bind time (compile + bucket warmup)",
                  buckets=_SWAP_BUCKETS).observe(bind_s)
    reg.histogram("repro_deploy_flip_seconds",
                  "swap_to() through the pre-flip backlog drain",
                  buckets=_SWAP_BUCKETS).observe(flip_s)
    mark_production(label)
    return SwapReport(
        old_label=old, new_label=label, backend=ver.backend, bind_s=bind_s,
        flip_s=flip_s, queued_at_flip=queued, drained=drained,
        plan_digest=getattr(ver.plan, "digest", None))


def hot_swap_async(engine, params, masks=None, *, label: str,
                   backend: Optional[str] = None, lsq_scales=None,
                   quant_bits: Optional[int] = None, warmup: bool = True,
                   drain_timeout: float = 30.0
                   ) -> "concurrent.futures.Future[SwapReport]":
    """Run :func:`hot_swap` on a daemon thread; resolve to its report."""
    fut: "concurrent.futures.Future[SwapReport]" = concurrent.futures.Future()

    def _run() -> None:
        if not fut.set_running_or_notify_cancel():
            return
        try:
            fut.set_result(hot_swap(engine, params, masks, label=label,
                                    backend=backend, lsq_scales=lsq_scales,
                                    quant_bits=quant_bits, warmup=warmup,
                                    drain_timeout=drain_timeout))
        except BaseException as e:  # noqa: BLE001 — surface to the caller
            fut.set_exception(e)

    threading.Thread(target=_run, daemon=True, name=f"hot-swap-{label}").start()
    return fut


def hot_swap_from_registry(
    engine,
    registry: ModelRegistry,
    spec: str,
    *,
    label: Optional[str] = None,
    backend: Optional[str] = None,
    warmup: bool = True,
    drain_timeout: float = 30.0,
) -> SwapReport:
    """Resolve ``name[@version|@alias]``, validate, and hot-swap to it.

    The loaded version's config must equal the engine's — the micro-batch
    frame shape and the bucket ladder are config-derived, so a
    config change is a redeploy, not a swap.  ``backend=None`` inherits
    the engine's (autotuned) serving backend; the assignment recorded at
    publish time only chose which plan artifacts were pre-warmed.
    """
    loaded = registry.load(spec)
    if loaded.cfg != engine.cfg:
        raise ValueError(
            f"registry version {loaded.version.spec} was trained with a "
            f"different SNNConfig than the engine is serving; hot-swap "
            f"requires matching configs (got {loaded.cfg} vs {engine.cfg})")
    return hot_swap(engine, loaded.params, loaded.masks,
                    label=label or loaded.version.spec, backend=backend,
                    lsq_scales=loaded.lsq_scales,
                    quant_bits=loaded.version.quant_bits,
                    warmup=warmup, drain_timeout=drain_timeout)
