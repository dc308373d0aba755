"""``flush_late_ms.*`` (ms): the median over the traced window's batches
that the batcher flushed at ``max_delay`` of how late each flush came past
its first request's pop plus ``max_delay``, on the batcher's clock, from
the program's span log (``repro_torch.obs.trace``, which records while the
profiler runs).  Nothing where the program has no span log, where the run
has no device trace (a CPU rehearsal), or where the window holds no
timeout flush or lost spans to the ring."""
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
    late = w.batches["late_s"][w.batches["kind"] == "timeout"]
    return float(np.median(late)) * 1e3 if len(late) else None
