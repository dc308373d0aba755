"""The device trace of a traced run, reduced to numbers.

After the measured window has closed and drained, the same traffic runs
again for ``TRACE_LEAD_S + TRACE_S`` seconds under ``torch.profiler`` (CPU
and CUDA activity); a host event marks its last ``TRACE_S`` seconds, the
traced window.  The profiler starts before that traffic and stops after it
has drained, so it never starts or stops while another thread launches
work on the card (on an NVIDIA H100 one traced run in six hung when the
profiler started and stopped mid-window).  The device events inside the
marked window give each device operation's time by name, the union of
device activity (busy seconds) and the idle gaps between, each gap named
by the innermost host event running at its middle.  Nothing is written
to disk.
"""
from __future__ import annotations

import bisect
import collections
from typing import Any, Dict, List, Tuple

TRACE_S = 1.0
TRACE_LEAD_S = 0.5
MARK = "amcbench::traced_window"
TOP = 10
# the longest idle gaps, each named by what the host was doing
LABELLED_GAPS = 400
NAME_CHARS = 120


class DeviceTrace:
    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        # the first profiler session of a process initialises the tracing
        # library (a second or more): do it at set-up
        with profile(activities=activities):
            torch.ones(1, device=device).add_(1)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        self._prof = profile(activities=activities)
        self._mark = None

    def start(self) -> None:
        self._prof.start()

    def mark_start(self) -> None:
        from torch.profiler import record_function

        self._mark = record_function(MARK)
        self._mark.__enter__()

    def mark_end(self) -> None:
        self._mark.__exit__(None, None, None)

    def stop(self) -> None:
        self._prof.stop()

    def reduce(self) -> Dict[str, Any]:
        """``{"window_s", "busy_s", "ops": {name: s}, "gaps": {label: s},
        "device_events"}`` over the marked window."""
        from torch.autograd import DeviceType

        dev: List[Tuple[float, float, str]] = []
        host: List[Tuple[float, float, str]] = []
        lo = hi = None
        for e in self._prof.events():
            iv = (e.time_range.start, e.time_range.end, e.name)
            if e.name == MARK:
                lo, hi = iv[0], iv[1]
            elif e.device_type == DeviceType.CUDA:
                dev.append(iv)
            else:
                host.append(iv)
        if lo is None:
            raise RuntimeError("the traced window's mark is not in the trace")
        # device events clipped to the window
        dev = [(max(s, lo), min(t, hi), n) for s, t, n in dev if t > lo and s < hi]
        ops: Dict[str, float] = collections.defaultdict(float)
        for s, t, name in dev:
            ops[name[:NAME_CHARS]] += (t - s) * 1e-6
        busy: List[List[float]] = []
        for s, t, _ in sorted(dev):
            if busy and s <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], t)
            else:
                busy.append([s, t])
        gaps: Dict[str, float] = collections.defaultdict(float)
        host.sort()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        between = sorted(((b - a, a, b) for a, b in zip(edges[::2], edges[1::2])
                          if b > a), reverse=True)[:LABELLED_GAPS]
        for _, a, b in between:
            inner = list(_around(host, 0.5 * (a + b)))
            label = (min(inner, key=lambda h: h[1] - h[0])[2][:NAME_CHARS]
                     if inner else "host python (no traced op)")
            gaps[label] += (b - a) * 1e-6
        return {"window_s": (hi - lo) * 1e-6,
                "busy_s": sum(t - s for s, t in busy) * 1e-6,
                "ops": dict(ops), "gaps": dict(gaps), "device_events": len(dev)}


def _around(host: List[Tuple[float, float, str]], t: float):
    """Host events (sorted by start) that span time ``t``."""
    hi = bisect.bisect_right(host, (t, float("inf"), ""))
    # host events last well under a second; look back a bounded stretch
    for h in host[max(0, hi - 500):hi]:
        if h[0] <= t <= h[1]:
            yield h


def top(d: Dict[str, float]) -> List[List[Any]]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def kernel_seconds(reduced: Dict[str, Any], symbol: str) -> float:
    """Device seconds of the operations whose name holds ``symbol``."""
    return sum(s for name, s in reduced["ops"].items() if symbol in name)
