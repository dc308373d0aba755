"""The load: one client thread submitting frames to the engine in an open
loop, with every completion stamped by a done-callback.

Each request ``i`` carries pool frame ``idx[i]``; the pool is cycled in an
order drawn from the seed.  Arrays are allocated before the load starts, so
the window allocates nothing of the harness's but one small callback a
request.  The client sends each request at its due time from the arrival
process, whatever the engine is doing, and records how late it ran.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Any, Dict, Optional

import numpy as np

from amcbench import spec

PENDING, OK, FAILED = 0, 1, 2


class Load:
    """Traffic ``traffic`` (a mix's parameters) over ``pool`` (N, 2, L)."""

    def __init__(self, submit, pool: np.ndarray, traffic: Dict[str, Any],
                 seed: int, seconds: float, rate_fps: Optional[float] = None):
        self.submit = submit
        self.pool = pool
        if traffic["loop"] != "open":
            raise ValueError(f"unknown loop {traffic['loop']!r}")
        self.warm_s = float(traffic["warm_s"])
        self.seconds = float(seconds)
        self.rate_fps = float(rate_fps if rate_fps is not None else traffic["rate_fps"])
        self.due = spec.arrivals(traffic["arrivals"]).offsets(
            self.rate_fps, self.warm_s + self.seconds, seed)
        cap = len(self.due)
        rng = np.random.default_rng([seed, 1])
        order = rng.permutation(len(pool)).astype(np.int32)
        self.idx = np.resize(order, cap)
        self.sent = np.full(cap, np.nan)
        self.done = np.full(cap, np.nan)
        self.cls = np.full(cap, -1, np.int16)
        self.status = np.zeros(cap, np.int8)
        self.n_sent = 0
        self.t_start = None
        self._thread = threading.Thread(target=self._run, name="amcbench-load",
                                        daemon=True)

    # -- the window --------------------------------------------------------

    @property
    def t0(self) -> float:
        return self.t_start + self.warm_s

    @property
    def t1(self) -> float:
        return self.t0 + self.seconds

    def start(self) -> None:
        self.t_start = time.perf_counter() + 0.01
        self._thread.start()

    def join(self) -> None:
        self._thread.join()

    def wait_done(self, timeout_s: float) -> bool:
        """Wait until every sent request resolved; False on timeout."""
        limit = time.perf_counter() + timeout_s
        while time.perf_counter() < limit:
            if not (self.status[:self.n_sent] == PENDING).any():
                return True
            time.sleep(0.01)
        return False

    # -- client thread -----------------------------------------------------

    def _done(self, i: int, fut) -> None:
        self.done[i] = time.perf_counter()
        if fut.exception() is None:
            self.cls[i] = fut.result()
            self.status[i] = OK
        else:
            self.status[i] = FAILED

    def _send(self, i: int, now: float) -> None:
        self.sent[i] = now
        fut = self.submit(self.pool[self.idx[i]])
        fut.add_done_callback(functools.partial(self._done, i))

    def _run(self) -> None:
        due = self.t_start + self.due
        for i in range(len(due)):
            # block (the interpreter lock let go) until the request is
            # due; one that is already due is sent at once
            ahead = due[i] - time.perf_counter()
            if ahead > 0:
                time.sleep(ahead)
            self._send(i, time.perf_counter())
            self.n_sent = i + 1

    # -- what the window saw -----------------------------------------------

    def window_requests(self) -> np.ndarray:
        """Indices of the requests due in the window."""
        t = self.t_start + self.due[:self.n_sent]
        return np.nonzero((t >= self.t0) & (t < self.t1))[0]

    def completed_between(self, a: float, b: float) -> np.ndarray:
        """Indices of requests that completed in [a, b)."""
        d = self.done[:self.n_sent]
        return np.nonzero((d >= a) & (d < b) & (self.status[:self.n_sent] == OK))[0]

    def latencies_ms(self) -> np.ndarray:
        """Due to completion, in ms, of every request due in the window;
        one that failed or never resolved is +inf."""
        w = self.window_requests()
        lat = (self.done[w] - (self.t_start + self.due[w])) * 1e3
        lat[self.status[w] != OK] = np.inf
        return lat

    def lateness_ms(self) -> np.ndarray:
        """How late the client sent each request, in ms."""
        n = self.n_sent
        return (self.sent[:n] - (self.t_start + self.due[:n])) * 1e3
