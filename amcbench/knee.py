"""The knee of a configuration: the highest offered rate (open-loop
Poisson, single-frame requests) at which the backlog does not grow through
the window.  Run once on the card to set an open-loop mix's ``rate_fps``;
not part of a benchmark run.

    python3 amcbench/knee.py --workload snn-f32-fused.steady --seed 7 \
        --seconds 5 --rates 20000,30000,40000

For each rate prints one JSON line: the completed rate, the backlog
(requests sent and not yet completed) at the window's middle and end,
p50 and p99 latency, and whether the backlog grew (by more than one
``max_batch`` from the middle to the end, or past ``4 x max_batch``).
"""
from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def backlog(load, t: float) -> int:
    n = load.n_sent
    return int((load.sent[:n] <= t).sum() - (load.done[:n] <= t).sum())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    os.environ["REPRO_TORCH_PLAN_CACHE_DIR"] = str(ROOT / "amcbench" / "out" / "plans")
    from amcbench.harness import run_cell

    for rate in (float(r) for r in args.rates.split(",")):
        out = run_cell(ROOT, args.workload, args.seed, args.seconds, False,
                       time.perf_counter(), "cuda", rate_fps=rate)
        run = out["run"]
        load = run.load
        mid, end = backlog(load, 0.5 * (run.t0 + run.t1)), backlog(load, run.t1)
        lat = load.latencies_ms()
        done = len(load.completed_between(run.t0, run.t1))
        grew = end > mid + run.max_batch or end > 4 * run.max_batch
        late = out["info"].get("generator_late_ms", {})
        print(json.dumps({
            "workload": args.workload, "rate_fps": rate,
            "completed_fps": done / (run.t1 - run.t0),
            "backlog_mid": mid, "backlog_end": end, "grew": bool(grew),
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "batch_fill": (run.snap1["requests"] - run.snap0["requests"]) / max(
                1, (run.snap1["batches"] - run.snap0["batches"]) * run.max_batch),
            "generator_late_ms": late, "correct": out["line"]["correct"]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
