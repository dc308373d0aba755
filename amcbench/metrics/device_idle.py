"""``device_idle.*`` (frac): the share of the traced window's wall time
in which no kernel or copy ran on the card (``torch.profiler``); nothing
where the trace holds no device event."""


def read(run, name):
    if run.trace is None or not run.trace["device_events"]:
        return None
    return 1.0 - run.trace["busy_s"] / run.trace["window_s"]
