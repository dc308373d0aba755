"""Serving tier of the port: micro-batcher and async engine."""
from repro_torch.serve.batcher import (
    DeadlineExceeded,
    EngineClosed,
    MicroBatcher,
    QueueFull,
    ServeFuture,
)
from repro_torch.serve.engine import AsyncAMCServeEngine, ServeStats

__all__ = [
    "AsyncAMCServeEngine",
    "ServeStats",
    "MicroBatcher",
    "ServeFuture",
    "DeadlineExceeded",
    "EngineClosed",
    "QueueFull",
]
