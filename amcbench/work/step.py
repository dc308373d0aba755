"""The whole step's operations a frame needs, by class of peak.

From the reference's pass over the pool (``Run.frame_counts``: each
frame's gated adds per layer) and the model's shape:

* the encoder: per input element, five operations to normalise (abs, max,
  divide, add, multiply) and three a timestep of Σ-Δ (add, subtract,
  compare);
* each conv's and FC's gated adds; an FC with bfloat16 weights runs on the
  tensor cores, so its adds count as multiply-adds there, two FLOPs each;
* four operations a LIF neuron update (multiply, add, compare, subtract),
  every conv neuron before its pool and every FC neuron but the last
  FC's, at every timestep (the current-sum readout sums the last FC's
  currents with no LIF);
* the readout's adds, one a class a timestep.

Every other operation counts at the f32 instruction peak.  The count does
not depend on which kernels serve the step.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def lif_neurons(spec) -> Dict[str, int]:
    out = {}
    width = spec["input_width"]
    for i, (_, _, oc) in enumerate(spec["conv_specs"]):
        out[f"conv{i + 1}"] = oc * width
        width //= spec["pool"]
    for i, (_, dout) in enumerate(spec["fc_specs"][:-1]):
        out[f"fc{i + 1}"] = dout
    return out


def per_frame(run) -> Dict[str, np.ndarray]:
    """``{peak class: ops of each pool frame}`` (the zero frame last)."""
    spec = run.config["model"]
    t = spec["timesteps"]
    counts = run.frame_counts
    n = len(next(iter(counts.values())))
    f32 = np.full(n, float(2 * spec["input_width"] * (5 + 3 * t)
                           + t * spec["n_classes"]))
    tensor = np.zeros(n)
    f32 += 4.0 * t * sum(lif_neurons(spec).values())
    for name, adds in counts.items():
        if name.startswith("fc") and run.config["dtype"] == "bfloat16":
            tensor += 2.0 * adds
        else:
            f32 += adds
    out = {"f32": f32}
    if tensor.any():
        out["bf16_tensor"] = tensor
    return out
