"""``step_mfu`` (%): the served step's share of the card's peak while it
runs: for the requests the window's steps served, each operation class's
count (``work/step.py``) over that class's peak, summed, over the seconds
the worker spent in those steps (the harness's span around each
``serve_step`` that started in the window).  A faster step, on the host
or on the card, raises it; fusing or removing a kernel leaves its meaning
as it is."""
import numpy as np

from amcbench.peaks import PEAKS
from amcbench.work.step import per_frame


def read(run, name):
    probe = run.probe
    n = min(probe.n, len(probe.t_call))
    calls, backs = probe.t_call[:n], probe.t_back[:n]
    inside = np.nonzero((calls >= run.t0) & (calls < run.t1) & np.isfinite(backs))[0]
    if not len(inside):
        return None
    # a step's requests resolve after it returns and before the next starts
    end = calls[inside[-1] + 1] if inside[-1] + 1 < n else np.nan
    end = end if np.isfinite(end) else np.inf
    frames = run.load.idx[run.load.completed_between(calls[inside[0]], end)]
    step_s = float((backs[inside] - calls[inside]).sum())
    if not len(frames) or step_s <= 0:
        return None
    peak_s = sum(float(ops[frames].sum()) / PEAKS[cls]
                 for cls, ops in per_frame(run).items())
    return 100.0 * peak_s / step_s
