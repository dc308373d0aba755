"""``resolve_ms.*`` (ms): the median ``engine.resolve`` span of the traced
window, the worker's time after a batch's step (predictions, stats,
registry, traces, every future and its callbacks), from the program's span
log (``repro_torch.obs.trace``, which records while the profiler runs).
Nothing where the program has no span log, where the run has no device
trace (a CPU rehearsal), or where the window holds no such span or lost
spans to the ring."""
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
    s = w.seconds("engine.resolve")
    return float(np.median(s)) * 1e3 if len(s) else None
