"""A kernel's share of its roofline over the traced window.

The least time the traced window's launches of the kernel could take is
the larger of its operations over the peak of their class and its bytes
over the HBM bandwidth (``work/<kernel>.py`` counts both for the frames
served in the traced window, the padded rows as the zero frame); the
share is that over the kernel's device time in the trace, in percent.
"""
from __future__ import annotations

from typing import Optional


from amcbench import spec
from amcbench.peaks import PEAK_BYTES, PEAKS
from amcbench.trace import kernel_seconds


def share(run, kernel: str) -> Optional[float]:
    if run.trace is None:
        return None
    work = spec.work(kernel)
    seconds = kernel_seconds(run.trace, work.KERNEL)
    if seconds <= 0:
        return None
    frames = run.traced_frames()
    n_batches = run.sub1["batches"] - run.sub0["batches"]
    ops, nbytes = work.ops_and_bytes(run, frames, n_batches)
    bound = max(ops / PEAKS[work.PEAK], nbytes / PEAK_BYTES)
    return 100.0 * bound / seconds
