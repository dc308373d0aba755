"""The served step captured in CUDA graphs: the port of the reference's
``jax.jit`` of Σ-Δ encode ∘ batch (``repro/serve/engine.py``).

:class:`CapturedStep` keeps one ``torch.cuda.CUDAGraph`` per input shape
of ``fn``, a device function from raw I/Q ``(B, IC, L)`` to one output
tensor (the logits, or the logits and the per-conv counters packed side
by side).  A call copies the host batch into the graph's static input,
replays the graph, copies its static output back to the host and waits
for it: one copy each way, one replay and one synchronise, however many
launches ``fn`` makes.  A shape seen for the first time is captured then
and kept, as ``jit`` traces a new shape.

How a capture is made, and why:

* one eager call of ``fn`` on a side stream first: it builds the kernels,
  packs their device operands and plans their launches, so the graph
  holds no host-to-device copy and no occupancy query;
* then the capture on that side stream, in ``thread_local`` error mode, so
  that other threads serving on the same card (a hot-swap binds while the
  old version serves; a fleet builds a replica while another serves) do
  not abort it with their allocations and synchronises;
* under one process-wide lock, since captures share torch's bookkeeping;
* into one memory pool shared by all graphs of the step.  A per-step lock
  serialises its replays and captures: they share the static buffers and
  the pool, and each replay copies its output out before the lock is let
  go.

A capture records the kernel launches it would make instead of counting
them (:mod:`repro_torch.kernels.launches`); every replay adds that record
to the wrappers' counts.  On the CPU nothing is captured: the engine runs
``fn`` eagerly.  On the card nothing falls back: a step that fails to
capture raises.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Mapping, NamedTuple, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.launches import add_launches, record_counts, recording

__all__ = ["EAGER_BACKENDS", "CapturedStep", "captures"]

#: Plain-torch backends whose step cannot be captured, each with the
#: reason; the engine serves them eagerly on the card.  A kernel backend
#: (``cuda``, ``cuda_fused``) is never listed: its step is captured or
#: the engine raises.
EAGER_BACKENDS: Dict[str, str] = {}

# captures share torch's capture stream bookkeeping: one at a time
_CAPTURE_LOCK = threading.Lock()


def captures(assignment: Union[str, Mapping[str, str]],
             device: torch.device) -> bool:
    """Whether the served step of ``assignment`` (a backend name or a
    ``{layer: backend}`` map) on ``device`` runs by graph replay."""
    if device.type != "cuda":
        return False
    names = (set(assignment.values()) if isinstance(assignment, Mapping)
             else {assignment})
    return not names & set(EAGER_BACKENDS)


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    static_in: torch.Tensor
    static_out: torch.Tensor
    host_in: torch.Tensor       # pinned
    host_out: torch.Tensor      # pinned
    launches: object            # wrapper -> launches a replay makes


class CapturedStep:
    """``fn`` served by CUDA-graph replay, one graph per input shape."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor],
                 device: torch.device):
        self._fn = fn
        self.device = device
        self._pool = torch.cuda.graph_pool_handle()
        self._graphs: Dict[Tuple[int, ...], _Graph] = {}
        self._lock = threading.Lock()
        self.replays = 0    # graph replays served so far

    def __call__(self, iq: np.ndarray) -> np.ndarray:
        """(B, IC, L) raw I/Q on the host -> ``fn``'s output on the host."""
        shape = tuple(iq.shape)
        with self._lock, torch.cuda.device(self.device), \
                torch.inference_mode():
            g = self._graphs.get(shape)
            if g is None:
                g = self._graphs[shape] = self._capture(shape)
            g.host_in.numpy()[...] = iq
            g.static_in.copy_(g.host_in, non_blocking=True)
            g.graph.replay()
            g.host_out.copy_(g.static_out, non_blocking=True)
            torch.cuda.current_stream().synchronize()
            add_launches(g.launches)
            self.replays += 1
            return g.host_out.numpy().copy()

    def eager(self, iq: np.ndarray) -> np.ndarray:
        """The same step without a graph: ``fn`` launched op by op (what
        a replay is held to, and timed against)."""
        with torch.cuda.device(self.device), torch.inference_mode():
            x = torch.as_tensor(iq, dtype=torch.float32, device=self.device)
            return self._fn(x).cpu().numpy()

    def _capture(self, shape: Tuple[int, ...]) -> _Graph:
        static_in = torch.zeros(shape, dtype=torch.float32, device=self.device)
        with _CAPTURE_LOCK:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._fn(static_in)          # builds, packs, plans
            side.synchronize()
            graph = torch.cuda.CUDAGraph()
            with recording() as launches, torch.cuda.graph(
                    graph, pool=self._pool, stream=side,
                    capture_error_mode="thread_local"):
                static_out = self._fn(static_in)
        return _Graph(graph=graph, static_in=static_in, static_out=static_out,
                      host_in=torch.empty(shape, dtype=torch.float32,
                                          pin_memory=True),
                      host_out=torch.empty(static_out.shape,
                                           dtype=static_out.dtype,
                                           pin_memory=True),
                      launches=launches)

    def shapes(self) -> Tuple[Tuple[int, ...], ...]:
        """The input shapes captured so far."""
        with self._lock:
            return tuple(self._graphs)

    def launches(self, shape: Tuple[int, ...]) -> Dict[str, int]:
        """{kernel: launches} one replay of ``shape``'s graph makes."""
        with self._lock:
            return record_counts(self._graphs[tuple(shape)].launches)

    def release(self) -> None:
        """Free every graph and its memory; a later call captures anew."""
        with self._lock:
            self._graphs.clear()
