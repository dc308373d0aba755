"""Fault-tolerant checkpointing: atomic, asynchronous, keep-N.

Port of ``repro/train/checkpoint.py``, with the same on-disk format, so
one checkpoint directory restores in either package:
``<dir>/step_N/arrays.npz`` holds the state's leaves as ``leaf_00000``,
``leaf_00001``, ... in ``jax.tree_util`` order (:mod:`repro_torch.tree`),
and ``manifest.json`` the step, each leaf's shape and dtype, and the
caller's ``extra`` fields.

* **Atomicity**: write ``<dir>/.tmp.step_N``, then ``os.rename`` it
  (atomic on POSIX), so a job killed mid-save never leaves a half-written
  checkpoint that a restart would load.
* **Async**: the host copy of every leaf is taken before ``save`` returns;
  the disk write runs on a background thread, one save in flight at a
  time, and its error surfaces on the next ``wait()`` or ``save()``.
* **Keep-N GC**: only the newest ``keep`` checkpoints stay.
* **Restore** validates leaf count and shapes against ``like`` before
  building anything, then places every leaf on a device: the one named,
  else the device of the leaf of ``like`` it replaces.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_unflatten

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _is_dtensor(leaf) -> bool:
    return hasattr(leaf, "device_mesh") and hasattr(leaf, "placements")


def _host(leaf) -> np.ndarray:
    """A host copy of one leaf (the caller may go on mutating the tensor);
    a DTensor is gathered whole first (a collective: every rank saves)."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        """Snapshot ``tree`` at ``step``.  Returns before the write if async."""
        self.wait()  # at most one save in flight
        arrays = {f"leaf_{i:05d}": _host(leaf)
                  for i, leaf in enumerate(tree_leaves(tree))}
        manifest = {
            "step": int(step),
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in arrays.items()},
            "extra": extra or {},
        }
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays, manifest), daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays, manifest)

    def _write(self, step: int, arrays: Dict[str, np.ndarray], manifest: Dict) -> None:
        try:
            tmp = os.path.join(self.directory, f".tmp.step_{step}")
            final = os.path.join(self.directory, f"step_{step}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic publish
            self._gc()
        except BaseException as e:  # noqa: BLE001 -- surfaced on wait()/save()
            self._error = e

    def wait(self) -> None:
        """Drain the save in flight; raise its error if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(f"async checkpoint save failed: {err!r}") from err

    def _gc(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: Optional[int]) -> Tuple[int, str]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return step, os.path.join(self.directory, f"step_{step}")

    def read_manifest(self, step: Optional[int] = None) -> Dict:
        """A checkpoint's manifest (default: the latest), arrays untouched."""
        _, path = self._step_dir(step)
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f)

    def restore(self, like: Any, step: Optional[int] = None,
                device=None) -> Tuple[Any, Dict]:
        """Rebuild a tree shaped like ``like`` from checkpoint ``step``
        (default: the latest), every leaf a tensor on ``device`` (default:
        the device of the ``like`` leaf it replaces, else the CPU); where
        the ``like`` leaf is a DTensor, a DTensor with its mesh and
        placements.

        Validates the leaf count and every shape first.  Returns
        ``(tree, manifest)``.
        """
        _, path = self._step_dir(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = tree_leaves(like)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            keys = sorted(data.files)
            if len(keys) != len(leaves):
                raise ValueError(
                    f"checkpoint has {len(keys)} leaves, expected {len(leaves)} "
                    "(model/optimizer structure changed?)")
            arrays = []
            for key, leaf in zip(keys, leaves):
                arr = data[key]
                if tuple(arr.shape) != tuple(np.shape(leaf)):
                    raise ValueError(f"leaf {key}: shape {arr.shape} != "
                                     f"expected {tuple(np.shape(leaf))}")
                arrays.append(arr)
        restored = []
        for arr, leaf in zip(arrays, leaves):
            if _is_dtensor(leaf):
                # laid out as the like leaf is, whatever layout it was
                # saved from (the reference's elastic restore)
                from torch.distributed.tensor import distribute_tensor

                restored.append(distribute_tensor(
                    torch.from_numpy(arr).to(leaf.device_mesh.device_type),
                    leaf.device_mesh, leaf.placements))
                continue
            dev = device if device is not None else (
                leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
            restored.append(torch.from_numpy(arr).to(dev))
        return tree_unflatten(like, restored), manifest
