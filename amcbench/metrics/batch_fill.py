"""``batch_fill.*`` (frac): real requests over batch slots in the window,
from the engine's ``ServeStats`` (requests / (batches x max_batch))."""


def read(run, name):
    batches = run.snap1["batches"] - run.snap0["batches"]
    if batches <= 0:
        return None
    return (run.snap1["requests"] - run.snap0["requests"]) / (
        batches * run.max_batch)
