"""Sigma-Delta spike encoding of I/Q frames (paper §IV-A).

Port of ``repro/core/encoder.py``.  First-order, unipolar, input
normalized to [0, 1]:

    integ_t = integ_{t-1} + x_t - y_{t-1}
    y_t     = 1  if integ_t >= 0.5 else 0

Every operation is a single IEEE-rounded add, subtract or divide, so the
bits equal the reference's (numpy and jax) exactly on any device.
"""
from __future__ import annotations

import torch

__all__ = ["normalize_iq", "sigma_delta_encode", "encode_frames"]


def normalize_iq(iq: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Map an I/Q frame (..., 2, L) into [0, 1] per frame (max-abs scaling)."""
    peak = iq.abs().amax(dim=(-2, -1), keepdim=True)
    return 0.5 * (iq / (peak + eps) + 1.0)


def sigma_delta_encode(x: torch.Tensor, osr: int) -> torch.Tensor:
    """x: (...,) values in [0, 1] -> bits (osr, ...) in {0, 1}."""
    integ = torch.zeros_like(x)
    y = torch.zeros_like(x)
    bits = []
    for _ in range(osr):
        integ = integ + x - y
        y = (integ >= 0.5).to(x.dtype)
        bits.append(y)
    return torch.stack(bits)


def encode_frames(iq: torch.Tensor, osr: int) -> torch.Tensor:
    """(..., 2, L) float I/Q -> (T=osr, ..., 2, L) binary spike frames."""
    return sigma_delta_encode(normalize_iq(iq), osr)
