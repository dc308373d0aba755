"""Warmup-race backend autotuner for the serving tier.

Port of ``repro/serve/autotune.py``.  Every backend gives the same logits
(``dense`` / ``goap`` / ``cuda`` / ``cuda_fused`` / ``stream``), but their
cost depends on the device and the batch: so at bind time the engine
races the candidates on the exact batch shape it is about to serve
(bind, warm up, time a few repetitions) and pins the winner.  A candidate
that raises (an unsupported layout, a backend this host lacks) is recorded
in the report's ``errors`` and excluded; if every candidate raises the
race falls back to ``goap``, the paper's dataflow, which binds from numpy
artifacts on any host.  The hand-written kernels are the exception: on
the card a ``cuda`` or ``cuda_fused`` candidate that fails to build, bind
or launch re-raises, so a broken kernel fails the engine's construction
instead of being served around on plain PyTorch.

Two granularities:

* :func:`autotune_backend` — one winner for the whole network;
* :func:`autotune_per_layer` — each conv/FC layer raced on its own input
  shape (the plan compiler's cost-model priors order the race and are
  recorded beside the timings), giving a ``{layer: backend}`` assignment
  for :func:`repro_torch.plan.compile_plan`
  (``AsyncAMCServeEngine(backend="per-layer")``).  ``cuda`` and
  ``cuda_fused`` share one cell per layer, so a layer won by either is
  assigned ``cuda_fused``: an all-kernel assignment then serves through
  the whole-network launch.

The stopwatch ends the warm-up and every timed repetition with
``torch.cuda.synchronize`` when the probe lies on the card: a launch
returns before the card finishes, and without the synchronise each
candidate would time its launch queue.

Unlike the reference, whose whole-network race binds the non-fused
candidates without a plan, every candidate here binds through the cached
:func:`~repro_torch.plan.compile_plan`: the artifacts derived for the
race are the serving plan's, and the engine's bind of the winner is a
cache hit.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = [
    "AutotuneReport",
    "PerLayerAutotuneReport",
    "default_candidates",
    "autotune_backend",
    "autotune_per_layer",
]

_CPU_CANDIDATES = ("dense", "goap")
_CUDA_CANDIDATES = ("dense", "goap", "cuda", "cuda_fused")

# Backends whose fast path is the whole-network kernel: raced through the
# plan's ``batch``, so the stopwatch times what would serve.
_FUSED_BACKENDS = ("cuda_fused",)

# Backends that run the hand-written kernels: on the card their failure is
# never excluded from a race, it propagates.
_KERNEL_BACKENDS = ("cuda", "cuda_fused")

# Per-layer cells that are the same cell under another name: ``cuda_fused``
# binds the ``cuda`` cell plus the whole-network operands.
_SAME_CELL = {"cuda": "cuda_fused"}


def _disqualify(errors: Dict[str, str], name: str, exc: Exception,
                device: torch.device) -> None:
    """Record a raising candidate in ``errors``, or re-raise when it is a
    hand-written kernel on the card."""
    if device.type == "cuda" and name in _KERNEL_BACKENDS:
        raise exc
    errors[name] = f"{type(exc).__name__}: {exc}"


@dataclasses.dataclass(frozen=True)
class PlanBinding:
    """A raced candidate: its backend name and its compiled plan.  The
    engine's ``make_fn`` builds its serving step from ``batch``."""

    backend: str
    plan: Any

    @property
    def batch(self) -> Callable:
        """The whole-network kernel for a fused backend, the layer-by-layer
        path for every other backend."""
        return (self.plan.batch if self.backend in _FUSED_BACKENDS
                else self.plan.bound.batch)


def default_candidates(quantized: bool = False, device=None) -> Tuple[str, ...]:
    """Backends worth racing on ``device`` (``None``: the card when there is
    one).  The hand-written kernels race only on the card: on the CPU their
    wrappers run the plain versions, which nothing serves.

    ``quantized=True`` (LSQ state present) also races the integer
    ``fixed`` backend.
    """
    if device is None:
        on_card = torch.cuda.is_available()
    else:
        on_card = torch.device(device).type == "cuda"
    base = _CUDA_CANDIDATES if on_card else _CPU_CANDIDATES
    return base + ("fixed",) if quantized else base


@dataclasses.dataclass(frozen=True)
class AutotuneReport:
    """Outcome of one warmup race (kept on the engine for introspection)."""

    choice: str
    timings_ms: Dict[str, float]      # successful candidates -> mean wall ms
    errors: Dict[str, str]            # failed candidates -> error summary
    batch_shape: Tuple[int, ...]
    fell_back: bool = False           # True when every candidate raised

    def summary(self) -> dict:
        return {
            "choice": self.choice,
            "timings_ms": dict(self.timings_ms),
            "errors": dict(self.errors),
            "batch_shape": list(self.batch_shape),
            "fell_back": self.fell_back,
        }


def autotune_backend(
    program,
    params,
    batch_shape: Sequence[int],
    *,
    masks=None,
    quant_fn=None,
    candidates: Optional[Sequence[str]] = None,
    reps: int = 2,
    budget_s: float = 5.0,
    fallback: str = "goap",
    make_fn: Optional[Callable] = None,
    device=None,
) -> AutotuneReport:
    """Race ``candidates`` on a zero probe of ``batch_shape`` on ``device``
    (the card unless ``device="cpu"``) and pin the fastest.

    ``make_fn(binding)`` builds the callable to time from a
    :class:`PlanBinding`; the engine passes its serving step (encode +
    forward) so the race measures what will serve.  The default times
    ``binding.batch`` on spike frames.  Candidates are scored on
    post-warm-up runs; one whose warm-up exceeded ``budget_s`` gets a
    single timed rep.
    """
    from repro_torch.plan import compile_plan

    dev = resolve_device(device)
    candidates = (tuple(candidates) if candidates is not None
                  else default_candidates(device=dev))
    timings: Dict[str, float] = {}
    errors: Dict[str, str] = {}
    probe = torch.zeros(tuple(batch_shape), dtype=torch.float32, device=dev)
    for name in candidates:
        try:
            if hasattr(quant_fn, "reset"):
                # a candidate that raised mid-bind must not skew the next
                # candidate's layer-order fake-quant index
                quant_fn.reset()
            plan = compile_plan(program, params, masks=masks,
                                quant_fn=quant_fn, assignment=name,
                                device=dev)
            binding = PlanBinding(backend=name, plan=plan)
            fn = binding.batch if make_fn is None else make_fn(binding)
            timings[name] = _time_steady_state(fn, probe, reps, budget_s)
        except Exception as e:  # noqa: BLE001 — any failure disqualifies
            _disqualify(errors, name, e, dev)
    if timings:
        choice, fell_back = min(timings, key=timings.get), False
    else:
        choice, fell_back = fallback, True
    return AutotuneReport(choice=choice, timings_ms=timings, errors=errors,
                          batch_shape=tuple(batch_shape), fell_back=fell_back)


def _time_steady_state(fn, probe: torch.Tensor, reps: int,
                       budget_s: float) -> float:
    """Mean post-warm-up wall ms of ``fn(probe)`` (the race's stopwatch);
    every call ends in a synchronise when the probe is on the card."""
    def run():
        fn(probe)
        if probe.device.type == "cuda":
            torch.cuda.synchronize(probe.device)

    with torch.inference_mode():
        t0 = time.perf_counter()
        run()                                  # build, bind and warm up
        warm = time.perf_counter() - t0
        n_reps = 1 if warm > budget_s else max(1, reps)
        t0 = time.perf_counter()
        for _ in range(n_reps):
            run()
        return (time.perf_counter() - t0) / n_reps * 1e3


# ---------------------------------------------------------------------------
# Per-layer mode: one race per weighted layer, priors from the plan compiler.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PerLayerAutotuneReport:
    """Outcome of a layer-by-layer backend race."""

    assignment: Dict[str, str]                 # layer name -> winning backend
    timings_ms: Dict[str, Dict[str, float]]    # layer -> candidate -> mean ms
    priors: Dict[str, Dict[str, float]]        # layer -> candidate -> predicted cost
    errors: Dict[str, Dict[str, str]]          # layer -> candidate -> error
    batch: int
    fell_back: Tuple[str, ...] = ()            # layers decided by the fallback

    def summary(self) -> dict:
        return {
            "assignment": dict(self.assignment),
            "timings_ms": {k: dict(v) for k, v in self.timings_ms.items()},
            "priors": {k: dict(v) for k, v in self.priors.items()},
            "errors": {k: dict(v) for k, v in self.errors.items()},
            "batch": self.batch,
            "fell_back": list(self.fell_back),
        }


def _layer_probe_shapes(program, batch: int):
    """(spec, probe shape) for every weighted layer, tracking pooling."""
    cfg = program.cfg
    width = cfg.input_width
    shapes = []
    for spec in program.layers:
        if spec.kind == "conv_lif":
            shapes.append((spec, (batch, cfg.timesteps, spec.ic, width)))
        elif spec.kind == "maxpool":
            width //= spec.pool
        elif spec.kind == "fc_lif":
            shapes.append((spec, (batch, cfg.timesteps, spec.din)))
    return shapes


def autotune_per_layer(
    program,
    params,
    batch: int,
    *,
    masks=None,
    quant_fn=None,
    candidates: Optional[Sequence[str]] = None,
    reps: int = 2,
    budget_s: float = 5.0,
    fallback: str = "goap",
    cache=None,
    device=None,
) -> PerLayerAutotuneReport:
    """Race the candidates **layer by layer** on each layer's own input
    shape (random binary spikes, seed 0), on ``device``.

    Each candidate's cells come from one cached ``compile_plan``; each
    layer's cell runs alone as a one-stage
    :class:`~repro_torch.models.graph.BoundProgram` (the kernel backends'
    whole-sequence path: one conv or FC launch and one LIF launch).  The
    measured minimum wins; the cost-model priors set the race order and
    are recorded for comparison; a ``cuda`` win goes to ``cuda_fused``
    when that was timed too, since the two time the same cell.  A layer
    whose every candidate raises takes ``fallback``, which the prior plan
    has already bound; a kernel candidate that raises on the card
    propagates.
    """
    from repro_torch.models.graph import BoundProgram
    from repro_torch.plan import compile_plan

    dev = resolve_device(device)
    candidates = (tuple(candidates) if candidates is not None
                  else default_candidates(device=dev))
    cache_kw = {"cache": cache} if cache is not None else {}
    # the prior plan derives each layer's artifacts once (shared with every
    # candidate plan through the artifact cache) and gives the priors
    prior_plan = compile_plan(program, params, masks=masks, quant_fn=quant_fn,
                              assignment=fallback, device=dev, **cache_kw)
    priors_all = prior_plan.cost_priors()

    candidate_plans = {fallback: prior_plan}
    candidate_errors: Dict[str, str] = {}

    def plan_for(cand: str):
        if cand in candidate_errors:
            return None
        if cand not in candidate_plans:
            try:
                candidate_plans[cand] = compile_plan(
                    program, params, masks=masks, quant_fn=quant_fn,
                    assignment=cand, device=dev, **cache_kw)
            except Exception as e:  # noqa: BLE001 — exclude the candidate
                _disqualify(candidate_errors, cand, e, dev)
                return None
        return candidate_plans[cand]

    rng = np.random.default_rng(0)
    assignment: Dict[str, str] = {}
    timings: Dict[str, Dict[str, float]] = {}
    errors: Dict[str, Dict[str, str]] = {}
    priors: Dict[str, Dict[str, float]] = {}
    fell_back = []
    for spec, shape in _layer_probe_shapes(program, batch):
        prior = priors_all.get(spec.name, {})
        priors[spec.name] = {k: v for k, v in prior.items() if k in candidates}
        order = sorted(candidates, key=lambda c: prior.get(c, float("inf")))
        probe = torch.as_tensor((rng.random(shape) < 0.5).astype(np.float32),
                                device=dev)
        lt: Dict[str, float] = {}
        le: Dict[str, str] = {}
        for cand in order:
            plan_c = plan_for(cand)
            if plan_c is None:
                le[cand] = candidate_errors[cand]
                continue
            cell = next(lp.cell for lp in plan_c.layers
                        if lp.spec.name == spec.name)
            bound = BoundProgram(backend=cand, stages=((spec, cell),))
            try:
                lt[cand] = _time_steady_state(bound.batch, probe, reps,
                                              budget_s)
            except Exception as e:  # noqa: BLE001 — exclude the candidate
                _disqualify(le, cand, e, dev)
        timings[spec.name], errors[spec.name] = lt, le
        if lt:
            win = min(lt, key=lt.get)
            if _SAME_CELL.get(win) in lt:   # the same cell, timed twice
                win = _SAME_CELL[win]
            assignment[spec.name] = win
        else:
            # a failed candidate never lands in the assignment: the engine
            # would hit the same error compiling it
            assignment[spec.name] = fallback
            fell_back.append(spec.name)
    return PerLayerAutotuneReport(
        assignment=assignment, timings_ms=timings, priors=priors,
        errors=errors, batch=batch, fell_back=tuple(fell_back))
