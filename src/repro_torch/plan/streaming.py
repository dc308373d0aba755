"""Fused single-loop inter-layer executor (the paper's streaming pipeline).

Port of ``repro/plan/streaming.py``: instead of running each layer over
the whole sequence before the next starts, :func:`run_streaming` threads
every layer's state through one loop over timesteps.  When every weighted
layer is assigned ``cuda_fused`` the loop collapses into one launch of the
whole-network kernel (:mod:`repro_torch.kernels.stream_fused`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models.graph import KIND_READOUT

__all__ = ["run_streaming", "run_streaming_batch"]


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
