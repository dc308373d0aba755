"""Content-addressed plan cache: in-memory LRU + on-disk artifact store.

Port of ``repro/plan/cache.py``.  Two tiers with different lifetimes:

* **plans** (memory only) — a compiled :class:`~repro_torch.plan.compile.
  ExecutionPlan` holds cells bound to device tensors, so it is cached per
  process, keyed by the plan digest;
* **layer artifacts** (memory + disk) — the numpy derivations (COO
  kernels, Algorithm-2 schedules, packed COO, block-sparse tilings)
  depend only on one layer's effective weights, so they are keyed per
  layer without the backend name or the device, and a process restart
  reloads them from disk instead of rebuilding them.

The disk directory defaults to ``~/.cache/repro_torch/plans`` and moves
with ``REPRO_TORCH_PLAN_CACHE_DIR`` (set it empty to turn the disk tier
off).  It is the port's own: the reference's tier pickles reference
classes, and unpickling one would import ``repro``.  Stored artifacts
hold numpy arrays and port classes only.  All disk I/O is best effort: a
corrupt or unwritable cache degrades to a rebuild, never to an error.
"""
from __future__ import annotations

import collections
import os
import pathlib
import pickle
import tempfile
import threading
from typing import Any, Dict, Optional

__all__ = ["PlanCache", "default_cache", "set_default_cache",
           "default_store_root"]

ENV_DIR = "REPRO_TORCH_PLAN_CACHE_DIR"
_DEFAULT_DIR = os.path.join("~", ".cache", "repro_torch", "plans")


def default_store_root() -> pathlib.Path:
    """Root of the on-disk stores (``~/.cache/repro_torch`` by default);
    the plan tier lives in ``<root>/plans``.  Follows
    ``REPRO_TORCH_PLAN_CACHE_DIR`` when it is set."""
    d = os.environ.get(ENV_DIR) or _DEFAULT_DIR
    return pathlib.Path(d).expanduser().parent


class PlanCache:
    # every cached plan holds its weights on its device, so ``max_plans``
    # bounds how many weight sets stay alive
    def __init__(self, disk_dir: Optional[str] = None, *,
                 max_plans: int = 8, max_layer_entries: int = 512,
                 max_disk_entries: int = 512):
        if disk_dir is None:
            disk_dir = os.environ.get(ENV_DIR, _DEFAULT_DIR)
        self.disk_dir = pathlib.Path(disk_dir).expanduser() if disk_dir else None
        self.max_plans = max_plans
        self.max_layer_entries = max_layer_entries
        self.max_disk_entries = max_disk_entries
        self._plans: "collections.OrderedDict[str, Any]" = collections.OrderedDict()
        self._layers: "collections.OrderedDict[str, Dict[str, Any]]" = collections.OrderedDict()
        self._lock = threading.RLock()
        self.stats: collections.Counter = collections.Counter()

    # -- whole plans (memory tier) ------------------------------------------

    def get_plan(self, digest: str):
        with self._lock:
            plan = self._plans.get(digest)
            if plan is not None:
                self._plans.move_to_end(digest)
                self.stats["plan_hits"] += 1
            else:
                self.stats["plan_misses"] += 1
            return plan

    def put_plan(self, digest: str, plan) -> None:
        with self._lock:
            self._plans[digest] = plan
            self._plans.move_to_end(digest)
            while len(self._plans) > self.max_plans:
                self._plans.popitem(last=False)

    # -- per-layer artifacts (memory + disk tiers) --------------------------

    def _layer_path(self, key: str) -> Optional[pathlib.Path]:
        return self.disk_dir / f"{key}.pkl" if self.disk_dir else None

    @staticmethod
    def _stored_form(artifacts: Dict[str, Any]) -> Dict[str, Any]:
        """What the cache keeps: the derivations only.  Effective weights
        are re-derived from the live params on every compile (they feed the
        digest before the cache is consulted), so a stored copy would only
        pin stale weight sets."""
        return {k: v for k, v in artifacts.items() if k != "w_eff"}

    def get_artifacts(self, key: str) -> Optional[Dict[str, Any]]:
        """A copy of the layer's artifacts (callers extend their own dict)."""
        with self._lock:
            hit = self._layers.get(key)
            if hit is not None:
                self._layers.move_to_end(key)
                self.stats["layer_memory_hits"] += 1
                return dict(hit)
        path = self._layer_path(key)
        if path is not None and path.exists():
            try:
                with open(path, "rb") as f:
                    artifacts = pickle.load(f)
            except Exception:  # noqa: BLE001 — a corrupt entry is rebuilt
                self.stats["layer_disk_errors"] += 1
            else:
                if isinstance(artifacts, dict):
                    self.stats["layer_disk_hits"] += 1
                    with self._lock:
                        self._layers[key] = dict(artifacts)
                        self._trim_layers()
                    return artifacts
        self.stats["layer_misses"] += 1
        return None

    def put_artifacts(self, key: str, artifacts: Dict[str, Any]) -> None:
        stored = self._stored_form(artifacts)
        if not stored:
            return
        with self._lock:
            self._layers[key] = stored
            self._layers.move_to_end(key)
            self._trim_layers()
        path = self._layer_path(key)
        if path is None:
            return
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    pickle.dump(stored, f, protocol=pickle.HIGHEST_PROTOCOL)
                os.replace(tmp, path)  # atomic: readers never see a partial
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            self._trim_disk()
        except Exception:  # noqa: BLE001 — the disk tier is best effort
            self.stats["layer_disk_errors"] += 1

    def _trim_layers(self) -> None:
        while len(self._layers) > self.max_layer_entries:
            self._layers.popitem(last=False)

    def _trim_disk(self) -> None:
        """Bound the disk tier: evict the least recently written entries."""
        entries = sorted(self.disk_dir.glob("*.pkl"),
                         key=lambda p: p.stat().st_mtime)
        for p in entries[: max(0, len(entries) - self.max_disk_entries)]:
            try:
                p.unlink()
            except OSError:
                pass

    # -- maintenance --------------------------------------------------------

    def clear(self, *, memory_only: bool = False) -> None:
        with self._lock:
            self._plans.clear()
            self._layers.clear()
        if not memory_only and self.disk_dir is not None and self.disk_dir.exists():
            for p in self.disk_dir.glob("*.pkl"):
                try:
                    p.unlink()
                except OSError:
                    pass


_default: Optional[PlanCache] = None
_default_lock = threading.Lock()


def default_cache() -> PlanCache:
    """Process-wide cache used when ``compile_plan`` gets no explicit one."""
    global _default
    with _default_lock:
        if _default is None:
            _default = PlanCache()
        return _default


def set_default_cache(cache: Optional[PlanCache]) -> None:
    """Swap (or reset, with None) the process-wide default cache."""
    global _default
    with _default_lock:
        _default = cache
