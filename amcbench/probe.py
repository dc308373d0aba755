"""A span around the served step, and the step's outputs kept for the check.

The engine's worker calls the primary version's ``serve_step`` once a
batch: raw I/Q (bucket, 2, L) on the host in, ``(logits, counters)`` on the
host out.  :class:`StepProbe` stands in that attribute, times each call
host to host into preallocated arrays, and while armed keeps references
(no copies: each batch and each output is a fresh array) to a sample of the
batches and their logits: the first ``FIRST_PER_BUCKET`` of every bucket
size, and of the rest those the seed draws with probability ``KEEP``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

FIRST_PER_BUCKET = 16
KEEP = 1 / 8
CAP = 1_000_000


class StepProbe:
    def __init__(self, engine, seed: int,
                 make_step: Optional[Callable[[Callable], Callable]] = None):
        ver = engine.get_version(engine.active_version)
        served = ver.serve_step
        self._inner = make_step(served) if make_step is not None else served
        self._keep = np.random.default_rng([seed, 2]).random(CAP) < KEEP
        self.t_call = np.full(CAP, np.nan)
        self.t_back = np.full(CAP, np.nan)
        self.n = 0
        self.armed = False
        self.kept: List[Tuple[np.ndarray, np.ndarray]] = []
        self._per_bucket: Dict[int, int] = {}
        ver.serve_step = self

    def __call__(self, iq: np.ndarray):
        t0 = time.perf_counter()
        out = self._inner(iq)
        t1 = time.perf_counter()
        i = self.n
        if i < CAP:
            self.t_call[i] = t0
            self.t_back[i] = t1
            if self.armed:
                seen = self._per_bucket.get(len(iq), 0)
                self._per_bucket[len(iq)] = seen + 1
                if seen < FIRST_PER_BUCKET or self._keep[i]:
                    self.kept.append((iq, out[0]))
        self.n = i + 1
        return out

    def step_ms(self, a: float, b: float) -> np.ndarray:
        """Host-to-host ms of the calls that started in [a, b)."""
        n = min(self.n, CAP)
        t0, t1 = self.t_call[:n], self.t_back[:n]
        sel = (t0 >= a) & (t0 < b) & np.isfinite(t1)
        return (t1[sel] - t0[sel]) * 1e3
