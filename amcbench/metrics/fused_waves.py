"""``fused_waves.*`` (waves): the mean over the traced window's batches of
the planned waves of the whole-network launch that served each (its
clusters over what the card holds at once; 0 for a batch that no such
launch served), from the program's span log's batch records (their
``waves``), which record while the profiler runs.  Nothing where the
program has no span log or its batch records carry no waves, where the run
has no device trace (a CPU rehearsal), or where the window holds no batch
or lost records to the ring."""
import numpy as np


def read(run, name):
    try:
        from repro_torch.obs.trace import span_window
    except ImportError:   # a program without the span log
        return None
    if run.trace is None or not run.trace["device_events"]:
        return None
    w = span_window(run.sub0["t"], run.sub1["t"])
    if w is None or "waves" not in w.batches or not len(w.batches["waves"]):
        return None
    return float(np.mean(w.batches["waves"]))
