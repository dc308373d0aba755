"""Content-addressed plan cache, memory tier.

Port of the memory tier of ``repro/plan/cache.py``: compiled plans keyed
by their digest, and per-layer numpy artifacts (COO kernels, schedules,
block-sparse tilings) keyed by the layer's weights, both in bounded LRU
maps.  The on-disk artifact tier is not ported yet.
"""
from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Optional

__all__ = ["PlanCache", "default_cache"]


class PlanCache:
    # every cached plan holds its weights on its device, so ``max_plans``
    # bounds how many weight sets stay alive
    def __init__(self, *, max_plans: int = 8, max_layer_entries: int = 512):
        self.max_plans = max_plans
        self.max_layer_entries = max_layer_entries
        self._plans: "collections.OrderedDict[str, Any]" = collections.OrderedDict()
        self._layers: "collections.OrderedDict[str, Dict[str, Any]]" = collections.OrderedDict()
        self._lock = threading.RLock()
        self.stats: collections.Counter = collections.Counter()

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

    def get_artifacts(self, key: str) -> Optional[Dict[str, Any]]:
        """A copy of the layer's artifacts (callers extend their own dict)."""
        with self._lock:
            hit = self._layers.get(key)
            if hit is None:
                self.stats["layer_misses"] += 1
                return None
            self._layers.move_to_end(key)
            self.stats["layer_hits"] += 1
            return dict(hit)

    def put_artifacts(self, key: str, artifacts: Dict[str, Any]) -> None:
        # effective weights are re-derived from live params on every compile
        stored = {k: v for k, v in artifacts.items() if k != "w_eff"}
        if not stored:
            return
        with self._lock:
            self._layers[key] = stored
            self._layers.move_to_end(key)
            while len(self._layers) > self.max_layer_entries:
                self._layers.popitem(last=False)


_default: Optional[PlanCache] = None
_default_lock = threading.Lock()


def default_cache() -> PlanCache:
    """Process-wide cache used when ``compile_plan`` gets no explicit one."""
    global _default
    with _default_lock:
        if _default is None:
            _default = PlanCache()
        return _default
