"""Fused single-loop inter-layer executor (the paper's streaming pipeline).

Port of ``repro/plan/streaming.py``: instead of running each layer over
the whole sequence before the next starts, :func:`run_streaming` threads
every layer's state through one loop over timesteps.  When every weighted
layer is assigned ``cuda_fused`` the loop collapses into one launch of the
whole-network kernel (:mod:`repro_torch.kernels.stream_fused`).
:func:`profile_layer_steps` times each layer's step on its own, offline.
"""
from __future__ import annotations

import time
from typing import Dict, Sequence, Tuple

import torch

from repro_torch.models.graph import KIND_READOUT, LayerCell

__all__ = ["init_stream_states", "run_streaming", "run_streaming_batch",
           "profile_layer_steps"]


def init_stream_states(cells: Sequence[LayerCell], x0) -> Tuple:
    """Initial carried state of every cell, chained through the graph.

    ``x0`` is the first layer's per-timestep input (``(B, IC0, W)``); each
    next layer's input is the previous cell's step output on it (the
    reference infers it abstractly; eager torch runs the one step).
    """
    states = []
    x = x0
    for cell in cells:
        state = cell.init_state(x)
        states.append(state)
        _, x = cell.step(state, x)
    return tuple(states)


def run_streaming_batch(plan, xs: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """(T, B, IC0, W) -> ((B, n_classes) logits, counters) in one loop over T."""
    cells = [lp.cell for lp in plan.layers]
    states = [None] * len(cells)
    for t in range(xs.shape[0]):
        x = xs[t]
        for i, cell in enumerate(cells):
            if t == 0:
                states[i] = cell.init_state(x)
            states[i], x = cell.step(states[i], x)
    logits = None
    counters: Dict[str, Dict] = {}
    for lp, state in zip(plan.layers, states):
        if lp.cell.finalize is None:
            continue
        out = lp.cell.finalize(state)
        if lp.spec.kind == KIND_READOUT:
            logits = out
        else:
            counters[lp.spec.name] = out
    return (logits if logits is not None else x), counters


def run_streaming(plan, frames: torch.Tensor):
    """(T, IC0, W) frames -> ``(logits, counters)``, as ``BoundProgram.run``.

    With a fused stack the counters are the per-conv-layer Tables I/III
    quantities the kernel computes.
    """
    from repro_torch.kernels.stream_fused import fused_counters, stream_fused_forward

    stack = plan.fused_stack()
    if stack is not None:
        logits, accs = stream_fused_forward(stack, frames[None])
        return logits[0], fused_counters(stack, accs[0])
    logits, counters = run_streaming_batch(plan, frames[:, None])
    return logits[0], counters


def profile_layer_steps(plan, frames: torch.Tensor, reps: int = 3,
                        registry=None) -> Dict[str, float]:
    """Time each layer's per-timestep step on its own (ms over T steps).

    An offline observability hook, never on the serving path (the fused
    loop has no per-layer boundaries to time).  ``frames`` is ``(T, IC0,
    W)`` (one sample, as in the reference) or ``(T, B, IC0, W)``.  Each
    cell steps T times from its initial state on the input the previous
    layer gives a zero frame; one warm-up call, then the best of ``reps``
    loops, each ended by ``torch.cuda.synchronize`` on the card.  Results
    land in the ``repro_plan_layer_step_ms{layer,backend}`` gauge of the
    port's registry and come back as ``{layer_name: ms_per_T_timesteps}``.
    """
    from repro_torch.obs.metrics import default_registry

    reg = registry if registry is not None else default_registry()
    gauge = reg.gauge(
        "repro_plan_layer_step_ms",
        "Isolated per-layer step time over T timesteps (ms)",
        ("layer", "backend"))

    def sync():
        if frames.device.type == "cuda":
            torch.cuda.synchronize(frames.device)

    n_t = frames.shape[0]
    x = torch.zeros_like(frames[0] if frames.dim() == 4 else frames[:1])
    out: Dict[str, float] = {}
    with torch.inference_mode():
        states0 = init_stream_states([lp.cell for lp in plan.layers], x)
        for lp, state0 in zip(plan.layers, states0):
            _, y = lp.cell.step(state0, x)     # warm-up
            sync()
            best = float("inf")
            for _ in range(max(1, reps)):
                state = state0
                t0 = time.perf_counter()
                for _ in range(n_t):
                    state, y = lp.cell.step(state, x)
                sync()
                best = min(best, time.perf_counter() - t0)
            ms = best * 1e3
            out[lp.spec.name] = ms
            gauge.labels(layer=lp.spec.name, backend=lp.backend).set(ms)
            x = y                              # the next layer's input
    return out
