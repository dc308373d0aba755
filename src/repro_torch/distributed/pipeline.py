"""Pipeline-stage runner: the paper's inter-layer streaming over devices.

Port of ``repro/distributed/pipeline.py``.  The SAOCDS accelerator
instantiates every SNN layer as its own hardware stage and streams
activations stage to stage with no global control logic (paper §III).
Here each stage runs on its own device (``devices[i]``; on the card on a
CUDA stream of its own), microbatches stream through, and the schedule is
the reference's fixed-length tick loop: ``n_micro + n_stages - 1`` ticks,
bubbles included as explicit no-op slots (a stage that has no microbatch
yet runs on zeros; stage 0 repeats the last microbatch at the tail; the
last stage banks its output only once microbatches arrive).

A stage's output at tick ``t`` is handed to stage ``i + 1`` for tick
``t + 1`` (the counterpart of ``ppermute``): the next stage's stream
waits for an event recorded after the producing call, so a stage's
compute overlaps its neighbours' on other streams or cards.  A device
list that repeats one card, or ``["cpu"] * n``, runs the same schedule.

Stages share one buffer shape; heterogeneous stages (the SNN's conv and
pool widths) embed into the max-shape buffer, the software analogue of
the accelerator's fixed-width inter-layer stream.

Where the reference's ``stage_fn`` branches on ``jax.lax.axis_index``, a
port ``stage_fn`` calls :func:`stage_index`, which is valid inside a stage
call, and runs only its own branch.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, List, Sequence

import torch

from repro_torch.tree import tree_map

__all__ = ["spmd_pipeline", "stack_stage_params", "stage_index"]

_local = threading.local()


def stage_index() -> int:
    """The index of the stage being called (``jax.lax.axis_index`` of the
    reference's stage axis); valid only inside a ``stage_fn`` call."""
    idx = getattr(_local, "stage", None)
    if idx is None:
        raise RuntimeError("stage_index() is valid only inside a stage_fn "
                           "call of spmd_pipeline")
    return idx


def stack_stage_params(per_stage_params) -> Any:
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage dim."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def _stream_ctx(stream):
    return torch.cuda.stream(stream) if stream is not None else \
        contextlib.nullcontext()


def spmd_pipeline(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    params: Any,                     # tree, leaves (n_stages, ...)
    microbatches: torch.Tensor,      # (n_micro, ...) one buffer shape
    devices: Sequence,
    *,
    collect: str = "psum",
) -> torch.Tensor:
    """Run ``y_mb = stageN(...stage0(x_mb))`` for every microbatch.

    Stage ``i`` runs ``stage_fn(params[i], x)`` on ``devices[i]``;
    ``stage_fn`` must keep the buffer shape (pad heterogeneous stages up).
    Returns the ``(n_micro, ...)`` outputs of the last stage: with
    ``collect="psum"`` on the device of ``microbatches`` (the reference's
    all-reduce gives every stage the result), with ``"stack"`` on the last
    stage's device (the reference's stage-local collection, whose last
    row it returns).
    """
    if collect not in ("psum", "stack"):
        raise ValueError(f"collect must be 'psum' or 'stack', not {collect!r}")
    devs = [torch.device(d) for d in devices]
    n_stages, n_micro = len(devs), microbatches.shape[0]
    ticks = n_micro + n_stages - 1
    buf_shape = tuple(microbatches.shape[1:])
    dtype = microbatches.dtype
    streams = [torch.cuda.Stream(d) if d.type == "cuda" else None
               for d in devs]
    stage_params = [tree_map(lambda x: x[i].to(d), params)
                    for i, d in enumerate(devs)]
    # every tensor handed between streams stays referenced until the
    # stages are waited for, so the allocator never recycles one that
    # another stream still reads
    keep: List[torch.Tensor] = []

    def ready(i: int):
        """An event on stage i's stream after its latest call (None off the
        card)."""
        if streams[i] is None:
            return None
        ev = torch.cuda.Event()
        ev.record(streams[i])
        return ev

    outputs = torch.zeros((n_micro,) + buf_shape, dtype=dtype,
                          device=devs[-1])
    # the stages start after what the caller enqueued (their params, the
    # outputs' zeros)
    for i, d in enumerate(devs):
        if streams[i] is not None:
            streams[i].wait_stream(torch.cuda.current_stream(d))
    state: List[Any] = [None] * n_stages     # (tensor, event) handed in
    for t in range(ticks):
        handoff: List[Any] = [None] * n_stages
        for i, d in enumerate(devs):
            with _stream_ctx(streams[i]):
                if i == 0:
                    # stage 0 injects microbatch t (clamped no-op slots at
                    # the tail)
                    x = microbatches[min(t, n_micro - 1)].to(d)
                elif state[i] is None:
                    x = torch.zeros(buf_shape, dtype=dtype, device=d)
                else:
                    y_prev, ev = state[i]
                    if ev is not None:
                        streams[i].wait_event(ev)
                    x = y_prev.to(d)
                keep.append(x)
                _local.stage = i
                try:
                    y = stage_fn(stage_params[i], x)
                finally:
                    _local.stage = None
                keep.append(y)
                out_t = t - (n_stages - 1)
                if i == n_stages - 1 and out_t >= 0:
                    # the last stage banks microbatch t - n_stages + 1
                    outputs[out_t].copy_(y)
                handoff[i] = (y, ready(i))
        # each output reaches the next stage at the next tick
        state = [None] + handoff[:-1]
    for stream in streams:
        if stream is not None:
            stream.synchronize()
    if collect == "stack":
        return outputs
    return outputs.to(microbatches.device)
