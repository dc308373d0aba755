"""Work of ``goap_conv_block_sparse`` (the float32 form): one launch per
conv stage a batch, spikes (T x B, IC, W) in, float32 currents out.

Operations (f32 instructions), per frame: the conv stages' gated adds.
Bytes: per frame each stage's input spikes (float32) read once and its
currents written once; per launch the stage's unpruned weights (float32
values) read once.  The shifted-input copy and the block indices the
kernel reads are not counted: the bound is the least the work needs.
"""
from __future__ import annotations

import numpy as np

KERNEL = "goap_conv_strip_kernel"
PEAK = "f32"


def ops_and_bytes(run, frames: np.ndarray, n_batches: int):
    """``(operations, bytes)`` of the launches that served ``frames``
    (pool indices, the zero frame for padded rows) in ``n_batches``."""
    spec = run.config["model"]
    t = spec["timesteps"]
    counts = run.frame_counts
    ops = 0.0
    per_frame = per_batch = 0
    width = spec["input_width"]
    for i, ((_, ic, oc), layer) in enumerate(zip(spec["conv_specs"],
                                                run.model.convs())):
        ops += float(counts[f"conv{i + 1}"][frames].sum())
        per_frame += 4 * t * (ic + oc) * width
        per_batch += 4 * int(layer.mask.ne(0).sum())
        width //= spec["pool"]
    return ops, per_frame * len(frames) + per_batch * n_batches
