"""Steps on fixed buffers, captured in CUDA graphs on the card: the port
of the reference's ``jax.jit`` of the SNN trainer's step and evaluation
(``repro/train/trainer.py``), of the language-model trainer's step, of
generation's prefill and decode step, and of a production cell's step
(``repro/launch/{train,serve,steps}.py``).

A captured graph reads and writes the same device memory on every replay,
so the trainer keeps its state in fixed buffers (:class:`TrainState`):
params, the optimizer's ``step``/``mu``/``nu``, LSQ scales and masks.  A
step reads them and writes the new state back into them inside its graph.
The trees a caller reads (``trainer.params`` and the like) are never those
buffers: a read after a step returns a copy of the buffers, made then and
kept until the next step, and a tree the caller assigns is copied into the
buffers before the next step or evaluation.  So a tree taken from the
trainer never changes, and an assigned tree takes effect without a new
capture.

:class:`StaticStep` runs a function of fixed input buffers once per call,
keyed as ``jit`` keys a trace (by its static arguments and input shapes):
on the card by replaying the key's CUDA graph, captured at the key's first
use through :func:`repro_torch.serve.capture.capture_graph` (the recipe the
served step uses: warm-ups on a side stream, then the capture there, in
``thread_local`` error mode, under the process-wide capture lock); with
``capture=False`` (and always on the CPU) by calling the function op by
op on the same buffers.  The host input goes through a pinned staging
buffer, copied on the step's stream; the host waits for that copy to end
before it writes the next batch there, and otherwise not at all, so it
prepares the next batch while the card runs the step.  An input given as
a tensor is copied into its buffer on the step's stream, unless it is
that buffer.  Nothing falls back: a capture that fails raises.

:func:`static_jit` is ``jax.jit(fn, donate_argnums=...)`` for a function
of tensor trees, built on a :class:`StaticStep`: the step's buffers hold
the arguments, and a donated argument's buffers are rewritten in place
with the output of the same position and handed back as that output, so
a loop that passes its outputs back in copies nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Hashable, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import (tree_leaves, tree_leaves_with_path, tree_map,
                              tree_unflatten)

__all__ = ["TrainState", "StaticStep", "static_jit"]


def _copy_into(dst_tree, src_tree, name: str) -> None:
    dst, src = tree_leaves(dst_tree), tree_leaves(src_tree)
    if len(dst) != len(src) or any(d.shape != s.shape
                                   for d, s in zip(dst, src)):
        raise ValueError(f"the assigned {name} tree does not match the "
                         "trainer's: its structure or a leaf's shape differs")
    for d, s in zip(dst, src):
        d.copy_(s)


class TrainState:
    """The trainer's state (``params``, ``opt``, ``lsq``, ``masks``) in
    fixed buffers on ``device``, with the trees handed to callers kept
    apart from them.

    * :meth:`get` returns the tree last assigned, or, after a step wrote
      the buffers, a copy of them made on that read (and kept until the
      buffers change again);
    * :meth:`set` keeps the caller's tree as it is and marks it to be
      copied into the buffers;
    * :meth:`buffers` copies every marked tree in (allocating a buffer at
      its first use) and returns the buffers;
    * :meth:`written` records that a step wrote some buffers.
    """

    NAMES = ("params", "opt", "lsq", "masks")

    def __init__(self, device: torch.device):
        self.device = device
        self._view: Dict[str, Any] = dict.fromkeys(self.NAMES)
        self._buf: Dict[str, Any] = dict.fromkeys(self.NAMES)
        self._stale: set = set()    # buffers newer than the view
        self._dirty: set = set()    # view newer than the buffers

    def get(self, name: str):
        if name in self._stale:
            with torch.no_grad():
                self._view[name] = tree_map(torch.clone, self._buf[name])
            self._stale.discard(name)
        return self._view[name]

    def set(self, name: str, tree) -> None:
        self._view[name] = tree
        self._stale.discard(name)
        self._dirty.add(name)

    def buffers(self) -> Dict[str, Any]:
        with torch.no_grad():
            for name in self._dirty:
                tree = self._view[name]
                if tree is None:
                    continue        # a step of that variant reads no buffer
                if self._buf[name] is None:
                    self._buf[name] = tree_map(
                        lambda x: torch.as_tensor(x).detach().to(
                            device=self.device, copy=True), tree)
                else:
                    _copy_into(self._buf[name], tree, name)
        self._dirty.clear()
        return dict(self._buf)

    def written(self, names: Iterable[str]) -> None:
        self._stale.update(n for n in names if self._buf[n] is not None)


@dataclasses.dataclass
class _Slot:
    inputs: Dict[str, torch.Tensor]          # fixed input buffers
    staging: Dict[str, torch.Tensor]         # pinned host copies (card)
    copied: Optional["torch.cuda.Event"]     # the last copy out of staging
    graph: Optional["torch.cuda.CUDAGraph"] = None
    out: Any = None


class StaticStep:
    """A function of fixed input buffers, run once per call and keyed as
    ``jit`` keys a trace.

    ``step(key, host, fn)``: ``host`` maps input names to numpy arrays or
    tensors, whose shapes and dtypes ``key`` must determine; they are
    copied into
    the key's fixed buffers, then ``fn(inputs, commit=True)`` runs on
    them, by replaying the key's CUDA graph when ``capture`` (captured at
    the key's first use, after ``warmups`` calls of ``fn(inputs,
    commit=False)`` on a side stream), else op by op.  Returns ``fn``'s
    output: with a graph, the graph's own output tensors, rewritten by its
    next replay.
    """

    def __init__(self, device: torch.device, capture: bool, warmups: int = 1):
        if capture and device.type != "cuda":
            raise ValueError(f"CUDA-graph capture needs a CUDA device, not "
                             f"{device}")
        self.device = device
        self.capture = capture
        self.warmups = warmups
        self.captures = 0      # graphs captured so far
        self._slots: Dict[Hashable, _Slot] = {}

    def keys(self):
        """The keys run so far (with ``capture``, one graph each)."""
        return tuple(self._slots)

    def __call__(self, key: Hashable, host: Dict[str, np.ndarray],
                 fn: Callable[[Dict[str, torch.Tensor], bool], Any]):
        slot = self._slots.get(key)
        if slot is None:
            slot = self._slots[key] = self._new_slot(host)
        self._stage(slot, host)
        if not self.capture:
            return fn(slot.inputs, True)
        with torch.cuda.device(self.device):
            if slot.graph is None:
                # imported here: repro_torch.serve imports the fixed tier,
                # which imports this package
                from repro_torch.serve.capture import capture_graph

                slot.graph, slot.out, _ = capture_graph(
                    lambda: fn(slot.inputs, True), self.device,
                    warmup=lambda: fn(slot.inputs, False),
                    warmups=self.warmups)
                self.captures += 1
            slot.graph.replay()
        return slot.out

    def _new_slot(self, host: Dict[str, Any]) -> _Slot:
        def dtype(a):
            if isinstance(a, torch.Tensor):
                return a.dtype
            return torch.from_numpy(np.empty(0, a.dtype)).dtype

        inputs = {k: torch.empty(a.shape, dtype=dtype(a), device=self.device)
                  for k, a in host.items()}
        if self.device.type != "cuda":
            return _Slot(inputs=inputs, staging={}, copied=None)
        staging = {k: torch.empty(a.shape, dtype=dtype(a), pin_memory=True)
                   for k, a in host.items() if not isinstance(a, torch.Tensor)}
        return _Slot(inputs=inputs, staging=staging,
                     copied=torch.cuda.Event())

    def _stage(self, slot: _Slot, host: Dict[str, Any]) -> None:
        tensors = {k: a for k, a in host.items()
                   if isinstance(a, torch.Tensor) and a is not slot.inputs[k]}
        arrays = {k: a for k, a in host.items()
                  if not isinstance(a, torch.Tensor)}
        if slot.copied is None:          # the CPU: a plain copy
            for k, a in tensors.items():
                slot.inputs[k].copy_(a)
            for k, a in arrays.items():
                slot.inputs[k].copy_(torch.from_numpy(np.ascontiguousarray(a)))
            return
        # the previous copy out of the pinned buffers must be over before
        # the host writes them again; the step itself is not waited for
        slot.copied.synchronize()
        with torch.cuda.device(self.device):
            for k, a in tensors.items():
                slot.inputs[k].copy_(a, non_blocking=True)
            for k, a in arrays.items():
                slot.staging[k].numpy()[...] = a
                slot.inputs[k].copy_(slot.staging[k], non_blocking=True)
            slot.copied.record()


def static_jit(fn: Callable, device: torch.device, *,
               donate_argnums: Tuple[int, ...] = (), capture=None,
               warmups: int = 1) -> Callable:
    """``jax.jit(fn, donate_argnums=donate_argnums)`` on ``device``.

    ``fn`` takes positional trees of tensors (numpy arrays are accepted
    too, staged through pinned memory) and returns a tuple.  Each call
    copies the arguments into the fixed buffers of their shapes (one
    :class:`StaticStep` key per tree structure, shape and dtype), then
    runs ``fn`` on them: by replaying its CUDA graph (``capture``, the
    default on a CUDA device; captured at the shapes' first call), else op
    by op.  Output ``i`` of a donated argument ``i`` is copied into that
    argument's buffers, which are returned in its place; the other outputs
    are ``fn``'s own (with a graph, its output tensors, rewritten by the
    next replay).
    """
    static = StaticStep(device, device.type == "cuda" if capture is None
                        else capture, warmups)

    def call(*args):
        pairs = tree_leaves_with_path(args)
        host = {"/".join(path): leaf for path, leaf in pairs}
        key = tuple((name, tuple(a.shape), str(a.dtype))
                    for name, a in host.items())

        def run(inputs, commit: bool):
            bufs = tree_unflatten(args, [inputs[k] for k in host])
            out = fn(*bufs)
            if commit and donate_argnums:
                out = list(out)
                with torch.no_grad():
                    for i in donate_argnums:
                        for dst, src in zip(tree_leaves(bufs[i]),
                                            tree_leaves(out[i])):
                            dst.copy_(src)
                        out[i] = bufs[i]
                out = tuple(out)
            return out

        return static(key, host, run)

    call.static = static
    return call
