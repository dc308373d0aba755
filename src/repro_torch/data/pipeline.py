"""Batched Σ-Δ encoders of the serving input stage.

Port of the encoders in ``repro/data/pipeline.py``: a numpy one for the
host and a torch one that runs wherever its input lies (the serve engine
runs it on the card, ahead of the fused kernel).  Both give the
reference's bits exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.encoder import encode_frames

__all__ = ["sigma_delta_encode_np", "sigma_delta_encode_batch"]


def sigma_delta_encode_np(iq: np.ndarray, osr: int) -> np.ndarray:
    """iq: (B, 2, L) float -> (B, T=osr, 2, L) float32 in {0, 1}."""
    peak = np.max(np.abs(iq), axis=(-2, -1), keepdims=True)
    x = 0.5 * (iq / (peak + 1e-8) + 1.0)
    integ = np.zeros_like(x)
    y_prev = np.zeros_like(x)
    bits = np.empty((osr,) + x.shape, dtype=np.float32)
    for t in range(osr):
        integ = integ + x - y_prev
        y_prev = (integ >= 0.5).astype(np.float32)
        bits[t] = y_prev
    return np.moveaxis(bits, 0, 1)


def sigma_delta_encode_batch(iq: torch.Tensor, osr: int) -> torch.Tensor:
    """(B, 2, L) -> (B, T, 2, L), on the device ``iq`` lies on."""
    return encode_frames(iq, osr).movedim(0, 1)
