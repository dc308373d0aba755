"""Fleet-scale serving: replica router, admission control, autoscaling.

The tier above :mod:`repro_torch.serve`: a :class:`FleetRouter` fronts N
replica groups (each an async engine) with join-shortest-queue dispatch,
per-request deadlines and priority classes, queue-bound + p99-driven load
shedding, and an :class:`Autoscaler` control loop that grows/shrinks the
replica set against a latency target.  The whole :mod:`repro_torch.deploy`
toolchain (hot-swap, canary routing, monitor) works on a fleet through
the router's engine-like surface.

Port of the reference's ``repro/fleet``: the same router, admission
control and control law over the port's engines.  On one card every
replica serves on that card (``engine_factory(..., device=)``), each with
its own worker threads and captured step graphs.
"""

from .autoscaler import AutoscaleTick, Autoscaler
from .router import FleetRouter, Replica, ShedError, engine_factory, merge_stats

__all__ = [
    "FleetRouter",
    "Replica",
    "ShedError",
    "engine_factory",
    "merge_stats",
    "Autoscaler",
    "AutoscaleTick",
]
