"""Poisson arrivals at a fixed rate, the same set of gaps for every seed.

The gaps are the exponential distribution's quantiles at ``(i + 0.5) / n``
for ``n = rate * seconds``, put in an order drawn from the seed: every seed
offers the same number of requests and the same set of gaps (so the same
work), in another order.  Independent receivers, each at its own steady
frame rate, arrive close to this.
"""
from __future__ import annotations

import numpy as np


def offsets(rate_fps: float, seconds: float, seed: int) -> np.ndarray:
    """Due times in seconds from the start, ascending, in [0, seconds)."""
    n = int(round(rate_fps * seconds))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate_fps
    gaps *= seconds / gaps.sum()         # the last arrival ends the span
    rng = np.random.default_rng(seed)
    due = np.cumsum(gaps[rng.permutation(n)])
    return np.concatenate([[0.0], due[:-1]])
