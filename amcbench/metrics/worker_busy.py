"""``worker_busy.*`` (frac): the engine worker's busy seconds
(``AsyncAMCServeEngine.busy_s``) over the window's seconds: host time
serving batches, not the device's share."""


def read(run, name):
    return (run.snap1["busy_s"] - run.snap0["busy_s"]) / (run.t1 - run.t0)
