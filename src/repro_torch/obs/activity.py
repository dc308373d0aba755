"""Live sparsity/activity telemetry: the paper's Tables I/III, per batch.

Port of ``repro/obs/activity.py``.  The iteration schedule (Table I:
reps/compute/extra/empty per conv layer, fixed by the masked weights) and
the gated accumulation counts (Table III, input-dependent) are the
paper's cost model.  The whole-network kernel (``cuda_fused``) and the
``stream`` interpreter produce those counters in their step; this module
surfaces them on the serving path as the reference's gauges, under the
same names:

* ``repro_activity_schedule{layer,counter}`` — the static Table I
  geometry, set once at bind time;
* ``repro_activity_frames_total{engine}`` — real frames counted;
* ``repro_activity_accumulations_total{engine,layer}`` — cumulative gated
  accumulations over real (non-padded) served frames;
* ``repro_activity_events_per_frame{engine,layer}`` — mean accumulations
  per frame in the last batch;
* ``repro_activity_accum_ratio_vs_dense{engine,layer}`` — last-batch
  events/frame over the dense MAC count (kw*ic*oc*W*T);
* ``repro_activity_effective_density{engine,layer}`` — events/frame over
  nnz*W*T.

Counters arrive as float32, exact below 2**24 events a frame.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry, default_registry

__all__ = ["SCHEDULE_KEYS", "ActivityObserver", "static_schedule_counts"]

#: Table I keys: fixed by the masked weights, independent of the input.
SCHEDULE_KEYS = ("reps_per_timestep", "compute_iters", "extra_iters",
                 "empty_iters")


def static_schedule_counts(plan) -> Dict[str, Dict[str, int]]:
    """Per-conv-layer Table I schedule geometry of a counter-capable plan.

    The fused stack carries it from bind time; a ``stream`` assignment
    reports it from one pass over an all-zero frame (no input activity:
    the accumulations stay 0, the schedule counts are constants).
    """
    from repro_torch.kernels.stream_fused import FusedConv

    stack = plan.fused_stack()
    if stack is not None:
        return {layer.name: dict(layer.static_counts)
                for layer in stack.layers if isinstance(layer, FusedConv)}
    cfg = plan.cfg
    zeros = torch.zeros((cfg.timesteps, cfg.conv_specs[0][1],
                         cfg.input_width), dtype=torch.float32,
                        device=plan.device)
    with torch.inference_mode():
        _, counters = plan.run_streaming(zeros)
    return {name: {k: int(c[k]) for k in SCHEDULE_KEYS}
            for name, c in counters.items()}


def _conv_geometry(plan, schedule) -> List[Dict[str, float]]:
    """Per conv layer: name, nnz, input width, T — the gauge denominators.

    Widths walk the layer graph (same-padded convs keep the width, each
    pool divides it); nnz is the schedule's compute iterations, one per
    nonzero weight.
    """
    from repro_torch.models.graph import KIND_CONV, KIND_POOL

    cfg = plan.cfg
    width = cfg.input_width
    out = []
    for lp in plan.layers:
        if lp.spec.kind == KIND_CONV:
            nnz = int(schedule[lp.spec.name]["compute_iters"])
            out.append({
                "name": lp.spec.name,
                "nnz": nnz,
                "width": width,
                "dense_macs_per_frame":
                    float(lp.spec.kw * lp.spec.ic * lp.spec.oc
                          * width * cfg.timesteps),
                "sparse_macs_per_frame": float(nnz * width * cfg.timesteps),
            })
        elif lp.spec.kind == KIND_POOL:
            width = width // max(1, lp.spec.pool)
    return out


class ActivityObserver:
    """Records one plan's per-batch activity counters into the registry.

    Built once per bound plan, off the hot path; per batch the serving
    worker calls :meth:`observe` with the host copy of the counters the
    plan's ``batch_counters`` step returned — a few float adds, no device
    work.
    """

    def __init__(self, plan, registry: Optional[MetricsRegistry] = None,
                 engine: str = "engine"):
        reg = registry if registry is not None else default_registry()
        self.engine = engine
        self.schedule = static_schedule_counts(plan)
        self.geometry = _conv_geometry(plan, self.schedule)
        self.timesteps = int(plan.cfg.timesteps)

        sched = reg.gauge(
            "repro_activity_schedule",
            "Table I static schedule geometry per conv layer "
            "(reps_per_timestep/compute_iters/extra_iters/empty_iters)",
            ("layer", "counter"))
        for name, counts in self.schedule.items():
            for key, val in counts.items():
                sched.labels(layer=name, counter=key).set(val)

        self._frames = reg.counter(
            "repro_activity_frames_total",
            "Real (non-padded) frames whose activity was counted",
            ("engine",)).labels(engine=engine)
        fam_acc = reg.counter(
            "repro_activity_accumulations_total",
            "Cumulative gated accumulations (Table III) over served frames",
            ("engine", "layer"))
        fam_epf = reg.gauge(
            "repro_activity_events_per_frame",
            "Mean gated accumulations per frame in the last served batch",
            ("engine", "layer"))
        fam_ratio = reg.gauge(
            "repro_activity_accum_ratio_vs_dense",
            "Last-batch events/frame over the dense MAC count "
            "(kw*ic*oc*W*T): the sparsity-proportionality readout",
            ("engine", "layer"))
        fam_dens = reg.gauge(
            "repro_activity_effective_density",
            "Last-batch events/frame over nnz*W*T: effective input-"
            "activity fraction", ("engine", "layer"))
        self._per_layer = {
            g["name"]: {
                "geom": g,
                "acc": fam_acc.labels(engine=engine, layer=g["name"]),
                "epf": fam_epf.labels(engine=engine, layer=g["name"]),
                "ratio": fam_ratio.labels(engine=engine, layer=g["name"]),
                "density": fam_dens.labels(engine=engine, layer=g["name"]),
            }
            for g in self.geometry
        }

    def observe(self, accumulations: Mapping[str, np.ndarray],
                n_real: int) -> None:
        """Account one served batch.

        ``accumulations``: per-conv-layer ``(B,)`` gated accumulation
        counts (host arrays).  Only the first ``n_real`` rows are real: the
        batcher pads the tail, and padded rows never reach the gauges.
        """
        if n_real <= 0:
            return
        self._frames.inc(n_real)
        for name, handles in self._per_layer.items():
            acc = accumulations.get(name)
            if acc is None:
                continue
            # float64: a batch's total passes 2**24 on the paper model
            total = float(np.asarray(acc, dtype=np.float64)[:n_real].sum())
            per_frame = total / n_real
            g = handles["geom"]
            handles["acc"].inc(total)
            handles["epf"].set(per_frame)
            handles["ratio"].set(per_frame / g["dense_macs_per_frame"])
            handles["density"].set(per_frame / g["sparse_macs_per_frame"])
