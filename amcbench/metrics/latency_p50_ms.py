"""``latency_p50_ms`` (ms): the median latency of the requests due in the
window, from each one's due time to its future's completion
(``Load.latencies_ms``; a failed or missing request counts as infinite)."""
import numpy as np


def read(run, name):
    lat = run.load.latencies_ms()
    return float(np.percentile(lat, 50)) if len(lat) else None
