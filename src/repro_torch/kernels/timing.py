"""Clocks for timing kernels on the card.

:func:`graph_ms` is the yardstick for a kernel's device time: ``calls``
back-to-back calls are captured into one CUDA graph, the graph is replayed
between two CUDA events, and the median replay is divided by ``calls``.
No host work lies between the events, so a kernel behind a Python wrapper
and a library call behind PyTorch's C++ dispatch are compared device time
with device time.  A wrapper can be captured only if it does not
synchronise with the host.  :func:`call_ms` keeps the older figure, one
call between two events, host work included.
"""
from __future__ import annotations

import statistics

import torch

__all__ = ["GRAPH_CALLS", "graph_ms", "call_ms"]

GRAPH_CALLS = 20


def graph_ms(fn, calls: int = GRAPH_CALLS, replays: int = 10,
             warmup: int = 3) -> float:
    """Median device milliseconds of one call of ``fn``, by graph replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm up off the capture stream
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of one call between two CUDA events; for a small
    kernel this is mostly the host's cost of the call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
