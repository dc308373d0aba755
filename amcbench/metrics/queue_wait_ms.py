"""``queue_wait_ms.*`` (ms): the median over the traced window's requests
of each one's queue wait, its batch's flush minus its enqueue on the
batcher's clock, from the program's span log (``repro_torch.obs.trace``,
which records while the profiler runs).  Nothing where the program has no
span log, where the run has no device trace (a CPU rehearsal), or where
the window holds no span or lost some to the ring."""
import numpy as np


def read(run, name):
    try:
        from repro_torch.obs.trace import span_window
    except ImportError:   # a program without the span log
        return None
    if run.trace is None or not run.trace["device_events"]:
        return None
    w = span_window(run.sub0["t"], run.sub1["t"])
    if w is None or not len(w.waits["wait_s"]):
        return None
    return float(np.median(w.waits["wait_s"])) * 1e3
