"""The served step captured in CUDA graphs: the port of the reference's
``jax.jit`` of Σ-Δ encode ∘ batch (``repro/serve/engine.py``).

:class:`CapturedStep` keeps one ``torch.cuda.CUDAGraph`` per input shape
of ``fn``, a device function from raw I/Q ``(B, IC, L)`` to one output
tensor (the logits, or the logits and the per-conv counters packed side
by side).  A call copies the host batch into the graph's static input,
replays the graph, copies its static output back to the host and waits
for it: one copy each way, one replay and one synchronise, however many
launches ``fn`` makes.  A shape seen for the first time is captured then
and kept, as ``jit`` traces a new shape.  Over a serving mesh (the port of
the reference's ``shard_map`` step) each device has its own function and
graphs; a batch is split evenly, every shard is copied in, every graph
replayed and every output copied out before the one wait on each device.

How a capture is made (:func:`capture_graph`, the recipe the trainer's
captured step shares), and why:

* one eager call of ``fn`` on a side stream first: it builds the kernels,
  packs their device operands and plans their launches, so the graph
  holds no host-to-device copy and no occupancy query;
* then the capture on that side stream, in ``thread_local`` error mode, so
  that other threads serving on the same card (a hot-swap binds while the
  old version serves; a fleet builds a replica while another serves) do
  not abort it with their allocations and synchronises;
* under one process-wide lock, since captures share torch's bookkeeping,
  and with Python's garbage collector paused, since a collected object
  that owns another graph would destroy it mid-capture;
* into one memory pool a device, shared by its graphs.  A per-step lock
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

import gc
import threading
from typing import (Any, Callable, Dict, List, Mapping, NamedTuple,
                    Optional, Sequence, Tuple, Union)

import numpy as np
import torch

from repro_torch.distributed.sharding import ServeMesh, shard_serve_fn, split_batch
from repro_torch.kernels.launches import add_launches, record_counts, recording
from repro_torch.obs.trace import span

__all__ = ["EAGER_BACKENDS", "CapturedStep", "capture_graph", "captures"]

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


def capture_graph(fn: Callable[[], Any], device: torch.device, *,
                  pool=None, warmup: Optional[Callable[[], Any]] = None,
                  warmups: int = 1):
    """Capture ``fn()`` into a CUDA graph on ``device``: the process's one
    capture recipe, shared by the served step and the trainer.

    ``warmup`` (default ``fn``) runs ``warmups`` times on a side stream
    first, so that what is built, packed, planned or initialised lazily
    (kernels, operands, cuBLAS handles, autograd's streams) is not
    captured; then ``fn`` is captured on that stream, in ``thread_local``
    error mode, under the process-wide capture lock, into ``pool``.  The
    warm-up's kernel launches are counted; the capture's are recorded.
    Returns ``(graph, fn's output tensors, launch record)``: a replay of
    ``graph`` rewrites the output tensors in place.
    """
    warm = fn if warmup is None else warmup
    with _CAPTURE_LOCK, torch.cuda.device(device):
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(warmups):
                warm()
        side.synchronize()
        graph = torch.cuda.CUDAGraph()
        # no garbage collection inside the capture: a collected object
        # that owns a graph (a dropped trainer or step) would destroy it
        # mid-capture, which invalidates the capture (torch's graph
        # context collects once on entry)
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            with recording() as launches, torch.cuda.graph(
                    graph, pool=pool, stream=side,
                    capture_error_mode="thread_local"):
                out = fn()
        finally:
            if gc_was_enabled:
                gc.enable()
    return graph, out, launches


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    device: torch.device
    static_in: torch.Tensor
    static_out: torch.Tensor
    host_in: torch.Tensor       # pinned
    host_out: torch.Tensor      # pinned
    launches: object            # wrapper -> launches a replay makes


class CapturedStep:
    """``fn`` served by CUDA-graph replay, one graph per input shape.

    ``fn`` and ``device`` may be sequences of equal length, one function
    per device of a serving mesh: each batch is then split evenly along
    its leading axis, shard ``i`` runs through device ``i``'s graph, and
    the outputs are gathered in order.  A call copies every shard in,
    replays every device's graph, copies every output out, then waits
    for each device once, so the devices run side by side.
    """

    def __init__(self, fn: Union[Callable[[torch.Tensor], torch.Tensor],
                                 Sequence[Callable[[torch.Tensor],
                                                   torch.Tensor]]],
                 device: Union[torch.device, Sequence[torch.device]]):
        self._fns = list(fn) if isinstance(fn, (list, tuple)) else [fn]
        self.devices = (list(device) if isinstance(device, (list, tuple))
                        else [device])
        if len(self._fns) != len(self.devices):
            raise ValueError(f"{len(self._fns)} step functions for "
                             f"{len(self.devices)} devices")
        self.device = self.devices[0]
        self._pools = []
        for dev in self.devices:
            with torch.cuda.device(dev):
                self._pools.append(torch.cuda.graph_pool_handle())
        # full batch shape -> one graph per device
        self._graphs: Dict[Tuple[int, ...], List[_Graph]] = {}
        self._lock = threading.Lock()
        self.replays = 0    # served steps (one replay on every device each)

    def __call__(self, iq: np.ndarray) -> np.ndarray:
        """(B, IC, L) raw I/Q on the host -> ``fn``'s output on the host."""
        shape = tuple(iq.shape)
        shards = split_batch(iq, len(self.devices))
        with self._lock, torch.inference_mode():
            gs = self._graphs.get(shape)
            if gs is None:
                gs = self._graphs[shape] = [
                    self._capture(i, tuple(x.shape))
                    for i, x in enumerate(shards)]
            with span("step.copy_in"):
                for g, x in zip(gs, shards):
                    g.host_in.numpy()[...] = x
                    with torch.cuda.device(g.device):
                        g.static_in.copy_(g.host_in, non_blocking=True)
            with span("step.replay"):
                for g in gs:
                    with torch.cuda.device(g.device):
                        g.graph.replay()
            with span("step.copy_out"):
                for g in gs:
                    with torch.cuda.device(g.device):
                        g.host_out.copy_(g.static_out, non_blocking=True)
            with span("step.sync"):
                for g in gs:
                    with torch.cuda.device(g.device):
                        torch.cuda.current_stream().synchronize()
            for g in gs:
                add_launches(g.launches)
            self.replays += 1
            with span("step.unpack"):
                return np.concatenate([g.host_out.numpy() for g in gs])

    def eager(self, iq: np.ndarray) -> np.ndarray:
        """The same step without a graph: ``fn`` launched op by op on each
        shard (what a replay is held to, and timed against)."""
        with torch.inference_mode():
            return shard_serve_fn(self._fns, ServeMesh(self.devices))(
                np.asarray(iq, np.float32)).numpy()

    def _capture(self, i: int, shape: Tuple[int, ...]) -> _Graph:
        dev = self.devices[i]
        static_in = torch.zeros(shape, dtype=torch.float32, device=dev)
        # the eager warm-up builds the kernels, packs and plans
        graph, static_out, launches = capture_graph(
            lambda: self._fns[i](static_in), dev, pool=self._pools[i])
        return _Graph(graph=graph, device=dev, static_in=static_in,
                      static_out=static_out,
                      host_in=torch.empty(shape, dtype=torch.float32,
                                          pin_memory=True),
                      host_out=torch.empty(static_out.shape,
                                           dtype=static_out.dtype,
                                           pin_memory=True),
                      launches=launches)

    def shapes(self) -> Tuple[Tuple[int, ...], ...]:
        """The (whole-batch) input shapes captured so far."""
        with self._lock:
            return tuple(self._graphs)

    def launches(self, shape: Tuple[int, ...]) -> Dict[str, int]:
        """{kernel: launches} one served step of ``shape`` makes, summed
        over the devices' replays."""
        with self._lock:
            total: Dict[str, int] = {}
            for g in self._graphs[tuple(shape)]:
                for name, n in record_counts(g.launches).items():
                    total[name] = total.get(name, 0) + n
            return total

    def release(self) -> None:
        """Free every graph and its memory; a later call captures anew."""
        with self._lock:
            self._graphs.clear()
