"""``step_host_ms.*`` (ms): the host's part of the served step, the median
over the traced window's ``engine.step`` spans of each one's wall time less
its ``step.sync`` children (the wait on the card), from the program's span
log (``repro_torch.obs.trace``, which records while the profiler runs).
Nothing where the program has no span log, where the run has no device
trace (a CPU rehearsal), or where the window holds no step or lost spans
to the ring."""
import numpy as np


def read(run, name):
    try:
        from repro_torch.obs.trace import span_window
    except ImportError:   # a program without the span log
        return None
    if run.trace is None or not run.trace["device_events"]:
        return None
    w = span_window(run.sub0["t"], run.sub1["t"])
    if w is None:
        return None
    sp = w.spans
    step = sp["name"] == "engine.step"
    if not step.any():
        return None
    host = sp["t1"][step] - sp["t0"][step]
    ids = sp["id"][step]
    order = np.argsort(ids)
    sync = sp["name"] == "step.sync"
    pos = np.searchsorted(ids[order], sp["parent"][sync]).clip(0, len(ids) - 1)
    mine = ids[order][pos] == sp["parent"][sync]
    np.subtract.at(host, order[pos[mine]],
                   (sp["t1"][sync] - sp["t0"][sync])[mine])
    return float(np.median(host)) * 1e3
