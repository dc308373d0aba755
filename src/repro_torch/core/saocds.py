"""Padding and pooling of the SAOCDS layer dataflow (paper §III-C.4).

Port of ``pad_same`` and ``max_pool_spikes`` from ``repro/core/saocds.py``.
The Algorithm-2 schedule interpreter (``make_schedule_step``) is not
ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["pad_same", "max_pool_spikes"]


def pad_same(ifm: torch.Tensor, kw: int) -> torch.Tensor:
    """Zero-pad (..., IC, W) so that a valid conv of width kw keeps W."""
    left = (kw - 1) // 2
    return F.pad(ifm, (left, kw - 1 - left))


def max_pool_spikes(spikes: torch.Tensor, pool: int = 2) -> torch.Tensor:
    """(..., C, W) -> (..., C, W//pool); max == logical OR for binary spikes."""
    *lead, c, w = spikes.shape
    w2 = (w // pool) * pool
    x = spikes[..., :w2].reshape(*lead, c, w2 // pool, pool)
    return x.amax(dim=-1)
