"""The serving mesh: data parallelism over the local cards.

Port of the serving half of ``repro/distributed/sharding.py``
(``serve_mesh``, ``serve_batch_pspec``, ``shard_serve_fn``).  Serving is
pure data parallelism: the SNN is tiny, so the only axis worth splitting is
the request batch.  :class:`ServeMesh` stands for the reference's 1-D
``("data",)`` mesh: its devices, its ``shape`` and ``axis_names``.

``PartitionSpec`` has no torch counterpart; :func:`serve_batch_pspec`
returns the split rule it stands for, as a tuple with one entry per batch
axis (``("data",)``: the leading axis splits evenly over the mesh's
devices), and :func:`shard_serve_fn` applies it.  The language-model rule
table of the reference's module waits for the model zoo.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["ServeMesh", "serve_mesh", "serve_batch_pspec", "shard_serve_fn",
           "split_batch"]


class ServeMesh:
    """A 1-D ``("data",)`` mesh over ``devices`` (a device may repeat: on
    the CPU every shard shares the one CPU device)."""

    axis_names = ("data",)

    def __init__(self, devices: Sequence[Union[str, torch.device]]):
        if not devices:
            raise ValueError("a serving mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = tuple(
            torch.device(d) for d in devices)

    @property
    def shape(self):
        return {"data": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"ServeMesh(data={self.size}, devices={list(self.devices)})"


def serve_mesh(n_devices: Optional[int] = None,
               device_type: str = "cuda") -> ServeMesh:
    """1-D ``("data",)`` mesh over the local cards for the serving tier.

    ``n_devices`` defaults to every local card; without a card it raises.
    With ``device_type="cpu"`` the ``n_devices`` (default 1) shards share
    the one CPU device, so the split and the gather run there as they
    would across cards.  A 1-device mesh is valid and keeps the sharded
    path identical from one card to many.
    """
    if device_type == "cpu":
        return ServeMesh([torch.device("cpu")] * (n_devices or 1))
    if device_type != "cuda":
        raise ValueError(f"unsupported device type {device_type!r}; use "
                         "'cuda' or 'cpu'")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' for a mesh on the CPU")
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"a mesh of {n} cards asked for; {count} present")
    return ServeMesh([torch.device("cuda", i) for i in range(n)])


def serve_batch_pspec(mesh: ServeMesh) -> Tuple[Optional[str]]:
    """The leading-axis batch split of serve batches on a ``serve_mesh``:
    ``("data",)`` splits it over the mesh's devices, ``(None,)``
    replicates it."""
    return ("data" if "data" in mesh.axis_names else None,)


def split_batch(x, n: int):
    """The split rule: ``n`` even slices of the leading (batch) axis of a
    tensor or a numpy array (views, in order)."""
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split evenly "
                         f"over {n} devices")
    return torch.chunk(x, n) if isinstance(x, torch.Tensor) else np.split(x, n)


def shard_serve_fn(fn: Union[Callable, Sequence[Callable]], mesh: ServeMesh):
    """Split a batched ``(B, ...) -> (B, ...)`` function over ``data``.

    ``fn`` is one function for every device, or one per mesh device (a
    step whose operands live on that device).  The wrapped function takes
    a tensor or a numpy array, splits its leading axis evenly (the
    micro-batcher aligns every bucket to the mesh, so the split is always
    even), runs each slice on its device, and gathers the outputs in order:
    on the input's device, or on the CPU for a numpy input.  Every shard
    is launched before any output is gathered, so the cards run side by
    side.  The per-shard bodies are independent (no collectives).
    """
    fns = list(fn) if isinstance(fn, (list, tuple)) else [fn] * mesh.size
    if len(fns) != mesh.size:
        raise ValueError(f"{len(fns)} functions for a mesh of {mesh.size}")
    split = serve_batch_pspec(mesh)[0] is not None

    def sharded(x):
        home = x.device if isinstance(x, torch.Tensor) else torch.device("cpu")
        shards = split_batch(x, mesh.size if split else 1)
        outs = []
        for f, dev, shard in zip(fns, mesh.devices, shards):
            # a card's kernels launch on its current stream
            with (torch.cuda.device(dev) if dev.type == "cuda"
                  else contextlib.nullcontext()):
                outs.append(f(torch.as_tensor(shard, device=dev)))
        return torch.cat([o.to(home) for o in outs])

    return sharded
