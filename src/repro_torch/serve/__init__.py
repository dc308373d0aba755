"""Serving tier of the port: micro-batcher, engines and the backend race."""
from repro_torch.serve.autotune import (
    AutotuneReport,
    PerLayerAutotuneReport,
    autotune_backend,
    autotune_per_layer,
    default_candidates,
)
from repro_torch.serve.batcher import (
    DEFAULT_PRIORITY_WEIGHTS,
    PRIORITIES,
    DeadlineExceeded,
    EngineClosed,
    MicroBatch,
    MicroBatcher,
    QueueFull,
    Request,
    ServeFuture,
)
from repro_torch.serve.engine import (
    AMCServeEngine,
    AsyncAMCServeEngine,
    BoundVersion,
    ServeStats,
)

__all__ = [
    "AMCServeEngine",
    "AsyncAMCServeEngine",
    "BoundVersion",
    "ServeStats",
    "MicroBatcher",
    "MicroBatch",
    "Request",
    "ServeFuture",
    "DeadlineExceeded",
    "QueueFull",
    "EngineClosed",
    "PRIORITIES",
    "DEFAULT_PRIORITY_WEIGHTS",
    "AutotuneReport",
    "PerLayerAutotuneReport",
    "autotune_backend",
    "autotune_per_layer",
    "default_candidates",
]
