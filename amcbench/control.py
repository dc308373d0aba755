"""Runs of a cell with a stand-in for the served step, to read the check's
numbers: the control (``--step control``, the reference one precision
down) or a fault (``--step stale|half|altered``), over several seeds in one
process.  Not part of a benchmark run.

    python3 amcbench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 5 --step control

Prints one JSON line a seed: the numbers, whether the run came out
correct (it must not), attempted and failed.
"""
from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--step", default="control")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    os.environ["REPRO_TORCH_PLAN_CACHE_DIR"] = str(ROOT / "amcbench" / "out" / "plans")
    from amcbench import faults
    from amcbench.harness import run_cell

    make = faults.control if args.step == "control" else faults.FAULTS[args.step]
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(ROOT, args.workload, seed, args.seconds, False,
                       time.perf_counter(), "cuda", override=make)
        info = out["info"]
        print(json.dumps({"workload": args.workload, "step": args.step,
                          "seed": seed, "correct": out["line"]["correct"],
                          "numbers": info["numbers"], "rows": info["rows"],
                          "answers": info["answers"],
                          "attempted": info["attempted"],
                          "failed": info["failed"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
