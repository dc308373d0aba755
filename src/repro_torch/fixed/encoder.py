"""Integer first-order Sigma-Delta encoder (Q0.15 accumulator).

Port of ``repro/fixed/encoder.py`` in torch int32 ops.  The hardware front
end quantizes the AGC-normalized input to Q0.15 once and runs the
modulator in integers:

    x_q     = round(x * 2^15)           (x in [0, 1] after max-abs AGC)
    integ  += x_q - y_prev * 2^15
    y       = 1 if integ >= 2^14 else 0

Normalization stays in float32 (it models the analog/AGC stage); every
step after the single quantization is exact integer arithmetic, mirrored
bit for bit by the NumPy golden in :mod:`repro_torch.fixed.golden`.
"""
from __future__ import annotations

import torch

from repro_torch.core.encoder import normalize_iq

__all__ = ["ENC_ONE", "ENC_HALF", "fixed_sigma_delta_encode",
           "fixed_encode_frames", "fixed_encode_batch"]

ENC_ONE = 1 << 15   # Q0.15 representation of 1.0
ENC_HALF = 1 << 14  # comparator threshold (0.5)


def fixed_sigma_delta_encode(x: torch.Tensor, osr: int) -> torch.Tensor:
    """x (...,) in [0, 1]  ->  bits (osr, ...) int32 in {0, 1}."""
    # x * 2^15 is exact in float32; torch.round rounds half to even
    xq = torch.round(x * float(ENC_ONE)).to(torch.int32)
    integ = torch.zeros_like(xq)
    y = torch.zeros_like(xq)
    bits = []
    for _ in range(osr):
        integ = integ + xq - y * ENC_ONE
        y = (integ >= ENC_HALF).to(torch.int32)
        bits.append(y)
    return torch.stack(bits)


def fixed_encode_frames(iq: torch.Tensor, osr: int) -> torch.Tensor:
    """(..., 2, L) float I/Q -> (T=osr, ..., 2, L) int32 spike frames."""
    return fixed_sigma_delta_encode(normalize_iq(iq), osr)


def fixed_encode_batch(iq: torch.Tensor, osr: int) -> torch.Tensor:
    """(B, 2, L) float I/Q -> (B, T, 2, L) int32 spike frames."""
    return fixed_encode_frames(iq, osr).movedim(0, 1)
