"""``step_ms.*`` (ms): the median host-to-host time of the served step
(``BoundVersion.serve_step``: copy in, encode, replay, copy back), from
the harness's span around each call that started in the window."""
import numpy as np


def read(run, name):
    ms = run.probe.step_ms(run.t0, run.t1)
    return float(np.median(ms)) if len(ms) else None
