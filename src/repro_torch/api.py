"""Public facade of the port: one model definition, four backends.

    from repro_torch.api import SNNConfig, compile_snn, compile_plan, init_snn

    cfg = SNNConfig()
    program = compile_snn(cfg)
    params = init_snn(0, cfg)                      # numpy-seeded He init
    plan = compile_plan(program, params, masks=masks,
                        assignment="cuda_fused")  # on the card
    logits = plan.batch(frames_b)                 # one kernel launch
    engine = AsyncAMCServeEngine(params, cfg, masks)  # races the backends
    logits = program.apply(params, frames, backend="goap", device="cpu")

Backends: ``dense``, ``goap`` (plain torch), ``cuda`` and ``cuda_fused``
(the hand-written kernels; ports of the reference's ``pallas`` and
``pallas_fused``), ``stream`` (the Algorithm-2 interpreter with the
Tables I/III counters) and ``fixed`` (the integer datapath).  Serving:
:class:`AsyncAMCServeEngine`, with live activity gauges and LSQ /
fixed-point quantized serving.  Channel scenarios and the robustness
sweep: :data:`SCENARIOS`, :func:`apply_scenario`,
:func:`evaluate_robustness`.
"""
from __future__ import annotations

from repro_torch.convert import masks_from_numpy, params_from_numpy
from repro_torch.models.graph import (
    BoundProgram,
    Conv1dLIF,
    FCLIF,
    LayerCell,
    LayerSpec,
    MaxPool,
    Readout,
    SNNProgram,
    available_backends,
    build_layer_graph,
    compile_snn,
    get_backend,
    register_backend,
    stream_totals,
)
from repro_torch.models.snn import (
    SNNConfig,
    density_report,
    init_snn,
    param_count,
    sparsify_params,
)
from repro_torch.plan import ExecutionPlan, PlanCache, compile_plan, run_streaming
from repro_torch.channel import (
    SCENARIOS,
    ChannelScenario,
    apply_scenario,
    make_frame_source,
)
from repro_torch.eval import RobustnessConfig, evaluate_robustness
from repro_torch.fixed import (
    FixedQuantFn,
    build_golden,
    fixed_encode_batch,
    fixed_logit_scale,
    quantize_codes,
)
from repro_torch.serve import AsyncAMCServeEngine, ServeStats
from repro_torch.train.pruning import make_mask_pytree

__all__ = [
    "LayerSpec",
    "LayerCell",
    "Conv1dLIF",
    "MaxPool",
    "FCLIF",
    "Readout",
    "build_layer_graph",
    "SNNProgram",
    "BoundProgram",
    "compile_snn",
    "ExecutionPlan",
    "PlanCache",
    "compile_plan",
    "run_streaming",
    "register_backend",
    "available_backends",
    "get_backend",
    "stream_totals",
    "SNNConfig",
    "init_snn",
    "sparsify_params",
    "param_count",
    "density_report",
    "ChannelScenario",
    "SCENARIOS",
    "apply_scenario",
    "make_frame_source",
    "RobustnessConfig",
    "evaluate_robustness",
    "FixedQuantFn",
    "build_golden",
    "fixed_encode_batch",
    "fixed_logit_scale",
    "quantize_codes",
    "make_mask_pytree",
    "params_from_numpy",
    "masks_from_numpy",
    "AsyncAMCServeEngine",
    "ServeStats",
]
