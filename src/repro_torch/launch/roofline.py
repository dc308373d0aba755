"""Roofline terms of a dry-run cell, and the streaming SNN's roofline.

Port of ``repro/launch/roofline.py`` on the machine model of
:data:`repro_torch.launch.mesh.HW` (an H100 SXM).  All terms are seconds
per step:

    t_compute    = dot_FLOPs_per_device     / peak_FLOP/s
    t_memory     = bytes_per_device         / HBM_bw
    t_collective = collective_bytes_per_dev / link_bw
    t_wire       = wire_bytes_per_dev       / link_bw      [ring model]

The reference reads the per-device numbers from a compiled XLA program;
the port has none, so :func:`roofline_terms` takes a :class:`CellCounts`
record that :mod:`repro_torch.launch.dryrun` counts.  ``model_flops`` is
the useful-work floor: 6*N*D (train), 2*N*D (prefill), 2*N*B (decode),
N = active params for MoE; ``useful_ratio`` < 1 exposes recomputation and
redundant compute, and ``mfu_bound`` is the MFU the step would reach at
the modelled bound (perfect overlap: step time = max(term)).
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.registry import ShapeSpec
from repro_torch.models.config import ArchConfig

from .mesh import HW

__all__ = ["CellCounts", "model_flops", "roofline_terms", "snn_stream_cost",
           "streaming_roofline"]


@dataclasses.dataclass
class CellCounts:
    """What one device does in one step of a cell (the role of the
    reference's ``HloAnalysis``)."""
    dot_flops: float            # matmul / einsum FLOPs
    bytes_accessed: float       # HBM bytes
    collective_bytes: float     # bytes the collectives return
    wire_bytes: float           # bytes sent over the links (ring model)


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    n = cfg.param_count(active_only=(cfg.family == "moe"))
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * b * s
    if shape.kind == "prefill":
        return 2.0 * n * b * s
    return 2.0 * n * b  # decode: one token


def roofline_terms(cfg: ArchConfig, shape: ShapeSpec, analysis: CellCounts,
                   chips: int) -> Dict:
    peak, hbm, link = HW["peak_flops_bf16"], HW["hbm_bw"], HW["link_bw"]
    flops_dev = analysis.dot_flops
    bytes_dev = analysis.bytes_accessed
    coll_dev = analysis.collective_bytes
    wire_dev = analysis.wire_bytes

    terms = {
        "compute": flops_dev / peak,            # == global / (chips * peak)
        "memory": bytes_dev / hbm,
        "collective": coll_dev / link,
    }
    bottleneck = max(terms, key=terms.get)
    t_bound = max(terms.values())

    mf = model_flops(cfg, shape)
    useful_ratio = mf / (flops_dev * chips) if flops_dev else 0.0
    mfu_bound = mf / (chips * peak * t_bound) if t_bound else 0.0

    return {
        "chips": chips,
        "per_device": {
            "dot_flops": flops_dev,
            "bytes_accessed": bytes_dev,
            "collective_bytes": coll_dev,
            "wire_bytes": wire_dev,
        },
        "global": {
            "dot_flops": flops_dev * chips,
            "bytes_accessed": bytes_dev * chips,
            "collective_bytes": coll_dev * chips,
        },
        "terms_s": {**terms, "wire": wire_dev / link},
        "bottleneck": bottleneck,
        "t_bound_s": t_bound,
        "model_flops": mf,
        "useful_ratio": useful_ratio,
        "mfu_bound": mfu_bound,
        "hw": HW["name"],
    }


# ---------------------------------------------------------------------------
# Streaming-SNN roofline (the fused multi-layer kernel's bytes/FLOP target)
# ---------------------------------------------------------------------------

def snn_stream_cost(cfg, density: float = 1.0) -> Dict:
    """Analytic per-frame work of the streaming SNN forward pass.

    ``cfg`` is a :class:`repro_torch.models.snn.SNNConfig`.  FLOPs follow
    the paper's counting: conv MACs scale with weight density (the GOAP
    dataflow executes only non-zero weights), LIF updates cost ~4 ops per
    neuron-timestep.  Bytes are the fused kernel's streaming plan: each
    weight fetched once, each binary input frame read once, the logits
    written once; membrane state never leaves the chip.  The
    layer-by-layer executor also round-trips every intermediate (T, C, W)
    spike sequence, reported as ``layered_extra_bytes``.
    """
    t_steps = cfg.timesteps
    width = cfg.input_width
    flops = 0.0
    weight_bytes = 0
    inter_bytes = 0
    for kw, ic, oc in cfg.conv_specs:
        flops += 2.0 * kw * ic * oc * width * density * t_steps  # GOAP MACs
        flops += 4.0 * oc * width * t_steps                       # LIF
        weight_bytes += kw * ic * oc * 4
        inter_bytes += 2 * t_steps * oc * width * 4               # w + r
        width //= cfg.pool
    for din, dout in cfg.fc_specs:
        flops += 2.0 * din * dout * t_steps + 4.0 * dout * t_steps
        weight_bytes += din * dout * 4
        inter_bytes += 2 * t_steps * dout * 4
    frame_bytes = t_steps * cfg.conv_specs[0][1] * cfg.input_width * 4
    return {
        "flops_per_frame": flops,
        "weight_bytes": weight_bytes,
        "frame_bytes": frame_bytes,
        "logit_bytes": cfg.n_classes * 4,
        "layered_extra_bytes": inter_bytes,
        "density": density,
    }


def streaming_roofline(cfg, density: float = 0.5, batch: int = 1,
                       chips: int = 1) -> Dict:
    """Roofline target for the fused streaming kernel on :data:`HW`.

    Weights amortise over the batch; frames and logits stream per sample.
    ``target_fps`` is the frames/s the modelled bound allows.  ``HW``
    quotes the bf16 tensor-core peak, as the reference quotes its TPU's;
    the port's fused kernel runs f32 on the CUDA cores, whose peak is far
    lower, so the target is the reference's yardstick, not that kernel's
    bound.
    """
    cost = snn_stream_cost(cfg, density)
    peak, hbm = HW["peak_flops_bf16"], HW["hbm_bw"]
    bytes_pf = (cost["frame_bytes"] + cost["logit_bytes"]
                + cost["weight_bytes"] / max(1, batch))
    flops_pf = cost["flops_per_frame"]
    t_compute = flops_pf / (chips * peak)
    t_memory = bytes_pf / (chips * hbm)
    t_bound = max(t_compute, t_memory)
    return {
        **cost,
        "bytes_per_frame": bytes_pf,
        "intensity_flops_per_byte": flops_pf / bytes_pf,
        "ridge_flops_per_byte": peak / hbm,
        "bound": "compute" if t_compute >= t_memory else "memory",
        "target_fps": 1.0 / t_bound,
        "batch": batch,
        "chips": chips,
        "hw": HW["name"],
    }
