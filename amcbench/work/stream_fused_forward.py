"""Work of ``stream_fused_forward``: the whole network in one launch a
batch, on Σ-Δ encoded frames (T, 2, L) float32.

Operations (f32 instructions), per frame: every conv's and FC's gated
adds, and four a LIF neuron update.  Bytes: per frame its encoded input
read once and its logits written once; per launch the unpruned weights
(float32 values) and each layer's three per-channel LIF parameters read
once.  Indices and scratch the kernel reads are not counted: the bound is
the least the work needs.
"""
from __future__ import annotations

import numpy as np

from amcbench.work.step import lif_neurons

KERNEL = "stream_fused_kernel"
PEAK = "f32"


def ops_and_bytes(run, frames: np.ndarray, n_batches: int):
    """``(operations, bytes)`` of the launches that served ``frames``
    (pool indices, the zero frame for padded rows) in ``n_batches``."""
    spec = run.config["model"]
    t = spec["timesteps"]
    counts = run.frame_counts
    lif = 4.0 * t * sum(lif_neurons(spec).values())
    ops = sum(float(c[frames].sum()) for c in counts.values()) + lif * len(frames)
    per_frame = 4 * (t * 2 * spec["input_width"] + spec["n_classes"])
    per_launch = 0
    for layer in run.model.layers:
        per_launch += 4 * int(layer.mask.ne(0).sum()) + 3 * 4 * layer.theta.numel()
    return ops, per_frame * len(frames) + per_launch * n_batches
