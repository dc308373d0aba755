"""Steps that stand in the served step's place to prove the check: the
control (the reference in the next precision down) and the faults a served
cell can have.  None of them runs in a benchmark run; ``control.py`` and
the tests under ``amcbench/tests`` pass them to ``run_cell(override=...)``.

Each is ``make(served_step, model, device) -> step``, where a step maps raw
I/Q (B, 2, L) on the host to ``(logits (B, n_classes), counters or None)``.
"""
from __future__ import annotations

import numpy as np
import torch

from amcbench.reference.snn import forward

# the configuration's dtype -> the control's weight precision
CONTROL_WEIGHTS = {torch.float32: "tf32", torch.bfloat16: "fp8"}


def control(served, model, device):
    """The reference with its weights one precision down (TF32 for a
    float32 model, fp8 e4m3 for a bfloat16 one), serving every batch."""
    weights = CONTROL_WEIGHTS[model.dtype]

    def step(iq):
        x = torch.from_numpy(np.asarray(iq, np.float32)).to(device)
        return forward(model, x, weights=weights).cpu().numpy(), None
    return step


def stale(served, model, device):
    """A step that returns its state unchanged: each bucket size's first
    output, again for every later batch."""
    first = {}

    def step(iq):
        out = served(iq)
        return first.setdefault(len(iq), out)
    return step


def half(served, model, device):
    """Half of the batch left out: its second half's rows get the mean of
    the first half's."""
    def step(iq):
        logits, accs = served(iq)
        logits = np.array(logits)
        h = len(logits) // 2
        if h:
            logits[h:] = logits[:h].mean(0)
        return logits, accs
    return step


def altered(served, model, device):
    """An answer altered where it is produced: the first row's logits
    rotated by one class in every batch."""
    def step(iq):
        logits, accs = served(iq)
        logits = np.array(logits)
        logits[0] = np.roll(logits[0], 1)
        return logits, accs
    return step


FAULTS = {"stale": stale, "half": half, "altered": altered}
