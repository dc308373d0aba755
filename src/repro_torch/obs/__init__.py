"""Observability of the port: metrics registry, request tracing and
activity telemetry (the analysis plane is not ported yet)."""
from repro_torch.obs.activity import (
    SCHEDULE_KEYS,
    ActivityObserver,
    static_schedule_counts,
)
from repro_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS,
    MetricsRegistry,
    default_registry,
    set_default_registry,
)
from repro_torch.obs.trace import (
    TERMINAL_EVENTS,
    RequestTrace,
    TraceEvent,
    TraceLog,
    begin_trace,
    disable_tracing,
    enable_tracing,
    get_tracer,
    tadd,
    tfinish,
)

__all__ = [
    "MetricsRegistry",
    "default_registry",
    "set_default_registry",
    "DEFAULT_LATENCY_BUCKETS",
    "TraceEvent",
    "RequestTrace",
    "TraceLog",
    "TERMINAL_EVENTS",
    "enable_tracing",
    "disable_tracing",
    "get_tracer",
    "begin_trace",
    "tadd",
    "tfinish",
    "ActivityObserver",
    "static_schedule_counts",
    "SCHEDULE_KEYS",
]
