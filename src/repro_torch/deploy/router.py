"""Weighted A/B + canary traffic splitting across bound model versions.

Port of ``repro/deploy/router.py`` (stdlib only, a copy).

The async engine's worker loop asks its router for a version label once
per micro-batch (batch granularity keeps the fixed-bucket shapes and the
zero-padding story intact — a batch is always served end-to-end by one
plan).  Routers are plain callables returning a label, so anything from a
hash ring to a bandit can be plugged in; the built-in
:class:`WeightedRouter` implements **smooth weighted round-robin** (the
nginx algorithm): deterministic, exactly proportional over any window,
and trivially testable — no RNG in the serving hot path.
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional

__all__ = ["WeightedRouter", "canary_router", "Router"]

Router = Callable[[], str]


class WeightedRouter:
    """Smooth weighted round-robin over version labels.

    Each pick adds every label's weight to its running credit, selects the
    label with the most credit, then debits the selected label by the
    total weight.  Over any window of N picks each label is chosen
    ``round(N * weight / total)`` times, with the picks interleaved (no
    bursts) — so a 5% canary sees traffic *throughout* the window, not a
    tail of it.
    """

    def __init__(self, weights: Dict[str, float]):
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {}
        self.set_weights(weights)

    def set_weights(self, weights: Dict[str, float]) -> None:
        clean = {str(k): float(v) for k, v in weights.items() if v > 0}
        if not clean:
            raise ValueError(f"no positive weights in {weights!r}")
        with self._lock:
            self.weights = clean
            self._credit = {k: 0.0 for k in clean}

    def __call__(self) -> str:
        with self._lock:
            total = sum(self.weights.values())
            for label, w in self.weights.items():
                self._credit[label] = self._credit.get(label, 0.0) + w
            pick = max(self._credit, key=lambda k: (self._credit[k], k))
            self._credit[pick] -= total
            self.counts[pick] = self.counts.get(pick, 0) + 1
            return pick

    def fractions(self) -> Dict[str, float]:
        """Observed traffic split (by routed batches)."""
        with self._lock:
            total = sum(self.counts.values())
            return {k: v / total for k, v in self.counts.items()} if total \
                else {}

    def summary(self) -> dict:
        with self._lock:
            total = sum(self.weights.values())
            return {
                "weights": {k: v / total for k, v in self.weights.items()},
                "routed_batches": dict(self.counts),
            }


def canary_router(primary: str, canary: str,
                  canary_pct: float) -> Optional[WeightedRouter]:
    """Router sending ``canary_pct``% of batches to the canary version.

    Returns ``None`` for a 0% canary (serve the primary directly — no
    router indirection in the hot path) and an all-canary router at 100%.
    """
    if not 0.0 <= canary_pct <= 100.0:
        raise ValueError(f"canary_pct must be in [0, 100], got {canary_pct}")
    if canary_pct == 0.0:
        return None
    if canary_pct == 100.0:
        return WeightedRouter({canary: 1.0})
    return WeightedRouter({primary: 100.0 - canary_pct, canary: canary_pct})
