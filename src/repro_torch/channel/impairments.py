"""The dataset generator's host-side channel (numpy).

Port of ``legacy_awgn_channel`` from ``repro/channel/impairments.py``,
the one function of that module that the RadioML generator needs.  The
module's jax-PRNG scenario impairments (fading, interference, timing) are
not ported yet.
"""
from __future__ import annotations

import numpy as np

__all__ = ["legacy_awgn_channel"]


def legacy_awgn_channel(
    rng: np.random.Generator, sig: np.ndarray, snr_db: float,
    max_cfo: float = 0.01, phase_noise: bool = True,
) -> np.ndarray:
    """AWGN + random CFO/phase (+ phase noise), vectorized numpy,
    deterministic in the ``rng`` state (bit-equal to the reference)."""
    n = len(sig)
    # random carrier frequency + phase offset
    cfo = rng.uniform(-max_cfo, max_cfo)
    phi0 = rng.uniform(0, 2 * np.pi)
    sig = sig * np.exp(1j * (2 * np.pi * cfo * np.arange(n) + phi0))
    if phase_noise:
        pn = np.cumsum(rng.normal(scale=2e-3, size=n))
        sig = sig * np.exp(1j * pn)
    # normalize signal power then add AWGN at requested SNR
    p_sig = np.mean(np.abs(sig) ** 2) + 1e-12
    sig = sig / np.sqrt(p_sig)
    p_noise = 10 ** (-snr_db / 10)
    noise = (rng.normal(size=n) + 1j * rng.normal(size=n)) * np.sqrt(p_noise / 2)
    return sig + noise
