"""Model lifecycle subsystem of the port: registry, hot-swap, canary
routing, monitor (port of ``repro/deploy``).

Turns the async serving tier into an operable deployment for the paper's
long-lived cognitive-radio edge node: publish trained models into a
content-addressed versioned :class:`ModelRegistry`, :func:`hot_swap` the
serving engine to a new version with zero dropped requests, split traffic
with :func:`canary_router`, and let :class:`CanaryMonitor` auto-promote
or auto-roll-back the canary on per-SNR accuracy or p99 latency
regressions.
"""

from .monitor import CanaryMonitor, MonitorConfig, WindowResult
from .registry import (
    LoadedModel,
    ModelRegistry,
    ModelVersion,
    publish_from_checkpoint,
    publish_from_trainer,
)
from .router import WeightedRouter, canary_router
from .swap import SwapReport, hot_swap, hot_swap_async, hot_swap_from_registry

__all__ = [
    "ModelRegistry",
    "ModelVersion",
    "LoadedModel",
    "publish_from_checkpoint",
    "publish_from_trainer",
    "SwapReport",
    "hot_swap",
    "hot_swap_async",
    "hot_swap_from_registry",
    "WeightedRouter",
    "canary_router",
    "CanaryMonitor",
    "MonitorConfig",
    "WindowResult",
]
