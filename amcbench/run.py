"""The benchmark's entry: one run of one cell on the card.

    python3 amcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints what it found on standard error (the card, set-up parts, the
generator's lateness, the check's numbers each beside its limit, last) and,
as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last.  Exits non-zero and prints no result
where there is no CUDA card (or fewer than the cell asks for), where the
program is missing, or where JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_PROC = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# a run that has not ended by then prints every thread's stack and exits
# non-zero, inside the 360 s a run may take
WATCHDOG_S = 330


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: ``repro_torch`` is the program)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)

    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    # the program's plan cache at a fixed path inside the checkout
    os.environ["REPRO_TORCH_PLAN_CACHE_DIR"] = str(ROOT / "amcbench" / "out" / "plans")

    from amcbench import spec

    cell = spec.resolve(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"amcbench: the cell needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"amcbench: the program is missing ({e})", file=sys.stderr)
        return 2
    from amcbench.harness import log, run_cell

    out = run_cell(ROOT, args.workload, args.seed, args.seconds,
                   bool(args.trace), T_PROC, "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"amcbench: loaded {bad} in the measuring process", file=sys.stderr)
        return 3
    log("info " + json.dumps(out["info"], sort_keys=True))
    for name, value, limit in out["checks"]:
        log(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(out["line"]), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
