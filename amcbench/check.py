"""What decides ``correct``: the served outputs against the reference.

After the window the reference computes the logits of every pool frame and
of the zero frame (the padded rows).  Two things the window produced are
held to them:

* the logits of the served batches the probe kept (``probe.py``: the first
  of every bucket size and a sample drawn from the seed), every row, padded
  rows included: a row's error is ``max |served - ref| / (1 + max |ref|)``;
* the answer of every request the window attempted: the class its future
  returned, against the reference's best class for its frame.

The numbers compared, each against its limit in the configuration's
``limits``:

* ``rows_off``: the share of checked rows whose error is above ``ROW_TOL``
  (a rounding of the served arithmetic stays far below it; a spike that
  fires differently, a wrong weight or a lower precision moves a row by
  about a weight, 1e-2 and more);
* ``answers_off``: the share of completed requests whose class is not the
  reference's best;
* ``row_err_max``: the widest row error.

A request that failed or never completed makes the run not correct, as
does a window that kept no batch.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from amcbench.load import OK

ROW_TOL = 1e-3


def served_rows(run) -> Tuple[np.ndarray, np.ndarray]:
    """``(pool index of each kept row (the zero frame is len(pool); -1 for a
    row that is no frame the load sent), its served logits)``."""
    pool = run.pool
    zero = len(pool)
    where = {pool[i].tobytes(): i for i in range(len(pool))}
    idx, rows = [], []
    for frames, logits in run.probe.kept:
        for r in range(len(frames)):
            f = frames[r]
            idx.append(zero if not f.any() else where.get(f.tobytes(), -1))
        rows.append(np.asarray(logits, np.float64))
    if not rows:
        return np.zeros(0, np.int64), np.zeros((0, 0))
    return np.asarray(idx), np.concatenate(rows)


def numbers(run, ref_logits: np.ndarray) -> Dict[str, float]:
    """The compared numbers, and how many rows and answers they cover."""
    idx, served = served_rows(run)
    ref = ref_logits.astype(np.float64)
    known = idx >= 0
    err = np.full(len(idx), np.inf)
    if known.any():
        want = ref[idx[known]]
        err[known] = (np.abs(served[known] - want).max(-1)
                      / (1.0 + np.abs(want).max(-1)))
    w = run.load.window_requests()
    done = w[run.load.status[w] == OK]
    best = ref.argmax(-1)
    wrong = run.load.cls[done] != best[run.load.idx[done]]
    return {
        "rows_off": float((err > ROW_TOL).mean()) if len(err) else 1.0,
        "answers_off": float(wrong.mean()) if len(done) else 1.0,
        "row_err_max": float(err.max()) if len(err) else float("inf"),
        "rows": int(len(err)),
        "answers": int(len(done)),
        "attempted": int(len(w)),
        "failed": int(len(w) - len(done)),
    }


def verdict(nums: Dict[str, float], limits: Dict[str, float]):
    """``(correct, [(name, value, limit)])`` over the limited numbers."""
    compared = [(k, nums[k], float(v)) for k, v in limits.items()]
    ok = (nums["failed"] == 0 and nums["rows"] > 0 and nums["answers"] > 0
          and all(v <= lim for _, v, lim in compared))
    return ok, compared
