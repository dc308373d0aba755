"""Precomputed execution plans: artifacts derived once, one fused loop over T."""
from repro_torch.plan.cache import PlanCache, default_cache, set_default_cache
from repro_torch.plan.compile import (
    ExecutionPlan,
    LayerPlan,
    artifact_build_count,
    compile_plan,
)
from repro_torch.plan.streaming import (
    init_stream_states,
    run_streaming,
    run_streaming_batch,
)

__all__ = [
    "PlanCache",
    "default_cache",
    "set_default_cache",
    "ExecutionPlan",
    "LayerPlan",
    "artifact_build_count",
    "compile_plan",
    "init_stream_states",
    "run_streaming",
    "run_streaming_batch",
]
