"""The cost of the serving worker's spans (:mod:`repro_torch.obs.trace`),
alone and in a served cell.

    python -m repro_torch.bench.span_cost [--n 200000]
    python -m repro_torch.bench.span_cost --cell snn-f32-fused.steady \\
        --seeds 11 12 13 14 [--seconds 51] [--root .] [--device cpu]

The first form times one span site (``with span(name): pass``) in a
thread of its own, as the serving worker meets it: off (no request
tracing, no profiler), on under request tracing, and on under a running
``torch.profiler`` (which adds the profiler range), as µs a span,
the median of ten blocks of ``n / 10`` spans.

The second runs a cell of the benchmark (``amcbench/``, from the
repository root ``--root``) traced, twice a seed in the order on, off,
off, on, ...: as built, and with every span site of the served path
forced off (``serve/batcher.py``, ``serve/engine.py``,
``serve/capture.py``).  Each run prints one JSON line: the traced run's
``step_ms.latency`` and ``worker_busy.latency`` (the untraced window),
the span metrics, and the traced second as the client saw it: the probe's
step median, the worker's busy share, and each request's latency (due to
done) and wait (sent to its step's start), whether the server kept up
with the load or fell behind it.  ``--device cpu`` rehearses it on a
small pool at 40 frames/s.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import threading
import time

from repro_torch.obs import trace

NAME = "span_cost"

_SITES = ("repro_torch.serve.batcher", "repro_torch.serve.engine",
          "repro_torch.serve.capture")


def _per_span_us(n: int) -> float:
    """Median µs of one ``engine.step`` span site, in a thread of its own."""
    out = []

    def work():
        blocks = []
        k = max(1, n // 10)
        for _ in range(11):
            t = time.perf_counter()
            for _ in range(k):
                with trace.span("engine.step"):
                    pass
            blocks.append((time.perf_counter() - t) / k * 1e6)
        out.append(statistics.median(blocks[1:]))   # the first warms

    th = threading.Thread(target=work)
    th.start()
    th.join()
    return out[0]


def span_costs(n: int = 200_000) -> dict:
    """µs a span: off, under request tracing, under a running profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    assert trace.get_tracer() is None, "request tracing is already on"
    res = {"off_us": _per_span_us(n)}
    trace.enable_tracing()
    try:
        res["tracing_us"] = _per_span_us(n)
    finally:
        trace.disable_tracing()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        res["profiler_us"] = _per_span_us(n)
    res["off_again_us"] = _per_span_us(n)
    return res


def _force_off():
    """Every span site of the served path off; returns the undo."""
    import importlib

    saved = []
    for name in _SITES:
        mod = importlib.import_module(name)
        for attr, off in (("span", lambda _name: trace._OFF),
                          ("span_log", lambda: None)):
            if hasattr(mod, attr):
                saved.append((mod, attr, getattr(mod, attr)))
                setattr(mod, attr, off)

    def undo():
        for mod, attr, val in saved:
            setattr(mod, attr, val)
    return undo


def _traced_second(run) -> dict:
    """The traced second from outside: the probe's steps, the busy share,
    and each request's latency and wait."""
    import numpy as np

    a, b, load = run.sub0, run.sub1, run.trace_load
    out = {"busy": (b["busy_s"] - a["busy_s"]) / (b["t"] - a["t"])}
    ms = run.probe.step_ms(a["t"], b["t"])
    out["probe_step_ms"] = float(np.median(ms)) if len(ms) else None
    n = load.n_sent
    due = load.t_start + load.due[:n]
    w = np.nonzero((due >= a["t"]) & (due < b["t"]))[0]
    lat = (load.done[w] - due[w]) * 1e3
    out["requests"] = int(len(w))
    out["unresolved"] = int((~np.isfinite(lat)).sum())
    lat = lat[np.isfinite(lat)]
    if len(lat):
        out["latency_ms"] = {"p50": float(np.median(lat)),
                             "p99": float(np.percentile(lat, 99)),
                             "max": float(lat.max())}
    pn = min(run.probe.n, len(run.probe.t_call))
    calls, backs = run.probe.t_call[:pn], run.probe.t_back[:pn]
    done = load.done[w]
    k = np.searchsorted(backs, done, side="right") - 1
    ok = np.isfinite(done) & (k >= 0)
    if ok.any():
        wait = (calls[k[ok]] - load.sent[w][ok]) * 1e3
        out["wait_ms"] = {"p50": float(np.median(wait)),
                          "max": float(wait.max())}
    return out


def cell_runs(root: str, cell: str, seeds, seconds: float,
              device: str = "cuda", **run_kw):
    """Traced runs of ``cell``, spans on and forced off in turn; yields
    one record a run (``run_kw`` goes to the harness's ``run_cell``)."""
    import pathlib

    root = str(pathlib.Path(root).resolve())
    for p in (root, root + "/src"):
        if p not in sys.path:
            sys.path.insert(0, p)
    from amcbench.harness import run_cell

    for i, seed in enumerate(seeds):
        for spans_on in ((True, False) if i % 2 == 0 else (False, True)):
            undo = None if spans_on else _force_off()
            try:
                out = run_cell(pathlib.Path(root), cell, seed, seconds, True,
                               time.perf_counter(), device, **run_kw)
            finally:
                if undo is not None:
                    undo()
            m = out["line"]["metrics"]
            yield {"cell": cell, "seed": seed, "spans": spans_on,
                   "correct": out["line"]["correct"],
                   "metrics": {k: v["value"] for k, v in m.items()},
                   "traced_second": _traced_second(out["run"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--cell")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--root", default=".")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.cell is None:
        print(json.dumps(span_costs(args.n)), flush=True)
        return 0
    small = (dict(pool_frames=96, rate_fps=40.0) if args.device == "cpu"
             else {})
    for rec in cell_runs(args.root, args.cell, args.seeds, args.seconds,
                         args.device, **small):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
