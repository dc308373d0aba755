"""RF channel impairments (the GNU Radio dynamic-channel family), in torch.

Port of ``repro/channel/impairments.py``.  Each impairment is split in two:

* a **draw** (``*_draws(rng, batch, ...)``) takes its random variates for a
  batch of frames from an explicit numpy ``Generator`` on the host and
  returns them as float32 numpy arrays with a leading batch axis;
* an **apply** (``carrier_offset(sig, draws)`` ...) is deterministic in
  those draws and runs on ``(B, L)`` complex64 tensors wherever they lie.

The draws reach the frames' device as tensors, so one seed gives the same
impaired frames on the CPU and on the card, within rounding (a CUDA
generator's stream would differ from the CPU's).  The reference draws
from ``jax.random`` keys instead; its streams are not reproduced, but
every apply takes the draws the reference's key would give (the tests
pass them in) and then computes what the reference computes.

Conventions: frequencies are normalized to the sample rate (cycles per
sample).  Multiplicative and resampling impairments preserve each frame's
average power (unitary rotations, or an explicit renormalization);
additive ones first normalize the frame to unit power (AWGN) or scale to
its current power (interference) and add energy at an analytically known
level.

:func:`legacy_awgn_channel` is the dataset generator's host-side numpy
channel, bit-equal to the reference's.
"""
from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

__all__ = [
    "to_complex",
    "to_iq",
    "avg_power",
    "normalize_power",
    "awgn",
    "awgn_draws",
    "carrier_offset",
    "carrier_offset_draws",
    "phase_noise",
    "phase_noise_draws",
    "timing_offset",
    "timing_offset_draws",
    "iq_imbalance",
    "iq_imbalance_draws",
    "multipath_fading",
    "multipath_fading_draws",
    "interferer_tones",
    "interferer_tones_draws",
    "legacy_awgn_channel",
]

Draws = Dict[str, np.ndarray]
_TWO_PI = 2 * math.pi


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _on(sig: torch.Tensor, a: np.ndarray) -> torch.Tensor:
    """A host draw as a float32 tensor on the frames' device."""
    return torch.as_tensor(a, dtype=torch.float32, device=sig.device)


def _col(sig: torch.Tensor, a: np.ndarray) -> torch.Tensor:
    """A per-frame scalar draw ``(B,)`` as a ``(B, 1)`` column."""
    return _on(sig, a)[:, None]


def _t(sig: torch.Tensor) -> torch.Tensor:
    """Sample index 0..L-1 as float32 on the frames' device."""
    return torch.arange(sig.shape[-1], dtype=torch.float32, device=sig.device)


def _rotate(phase: torch.Tensor) -> torch.Tensor:
    """exp(j * phase) as complex64."""
    return torch.polar(torch.ones_like(phase), phase)


# ---------------------------------------------------------------------------
# I/Q <-> complex plumbing.
# ---------------------------------------------------------------------------

def to_complex(iq: torch.Tensor) -> torch.Tensor:
    """(..., 2, L) real I/Q -> (..., L) complex64 baseband."""
    return torch.complex(iq[..., 0, :].float(), iq[..., 1, :].float())


def to_iq(sig: torch.Tensor) -> torch.Tensor:
    """(..., L) complex baseband -> (..., 2, L) float32 I/Q."""
    return torch.stack([sig.real, sig.imag], dim=-2).float()


def avg_power(sig: torch.Tensor) -> torch.Tensor:
    """Mean |x|^2 over each frame's last axis, kept as a (..., 1) column."""
    return (sig.abs() ** 2).mean(dim=-1, keepdim=True)


def normalize_power(sig: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rescale each frame to unit average power (the AWGN reference level)."""
    return sig / torch.sqrt(avg_power(sig) + eps)


def _match_power(out: torch.Tensor, ref: torch.Tensor,
                 eps: float = 1e-12) -> torch.Tensor:
    """Rescale each frame of ``out`` to the average power of ``ref``'s."""
    return out * torch.sqrt((avg_power(ref) + eps) / (avg_power(out) + eps))


# ---------------------------------------------------------------------------
# Additive impairments.
# ---------------------------------------------------------------------------

def awgn_draws(rng: np.random.Generator, batch: int, length: int) -> Draws:
    """Unit-variance real and imaginary noise parts, ``(B, L)`` each."""
    return {"re": _f32(rng.standard_normal((batch, length))),
            "im": _f32(rng.standard_normal((batch, length)))}


def awgn(sig: torch.Tensor, draws: Draws, snr_db) -> torch.Tensor:
    """Unit-normalize each frame, then add its complex white noise at
    ``snr_db`` (a scalar or one value per frame): the noise step of
    :func:`legacy_awgn_channel`."""
    sig = normalize_power(sig)
    noise = torch.complex(_on(sig, draws["re"]), _on(sig, draws["im"]))
    snr = torch.as_tensor(snr_db, dtype=torch.float32, device=sig.device)
    p_noise = 10.0 ** (-snr / 10.0)
    scale = torch.sqrt(p_noise / 2.0).reshape(-1, 1)
    return sig + noise * scale


def interferer_tones_draws(rng: np.random.Generator, batch: int,
                           f_min: float = 0.05, f_max: float = 0.45,
                           n_tones: int = 1) -> Draws:
    """Per frame and tone: ``|f|`` uniform in ``[f_min, f_max)``, a sign
    (+1 or -1, even odds) and a phase uniform in ``[0, 2 pi)``."""
    return {"f": _f32(rng.uniform(f_min, f_max, (batch, n_tones))),
            "sign": _f32(np.where(rng.random((batch, n_tones)) < 0.5,
                                  1.0, -1.0)),
            "phi": _f32(rng.uniform(0.0, _TWO_PI, (batch, n_tones)))}


def interferer_tones(sig: torch.Tensor, draws: Draws,
                     sir_db: float) -> torch.Tensor:
    """Add co-channel interferer tone(s) at the drawn adjacent offsets.

    Total interference power is ``10^(-sir_db/10)`` relative to the
    frame's current power, split evenly across the tones.
    """
    f = _on(sig, draws["sign"]) * _on(sig, draws["f"])        # (B, K)
    phi = _on(sig, draws["phi"])
    n_tones = f.shape[-1]
    tones = _rotate(_TWO_PI * f[..., None] * _t(sig) + phi[..., None])
    p_int = avg_power(sig) * 10.0 ** (-sir_db / 10.0)
    amp = torch.sqrt(p_int / n_tones)
    return sig + amp * tones.sum(dim=-2)


# ---------------------------------------------------------------------------
# Multiplicative (power-preserving) impairments.
# ---------------------------------------------------------------------------

def carrier_offset_draws(rng: np.random.Generator, batch: int, max_cfo: float,
                         random_phase: bool = True) -> Draws:
    """A CFO uniform in ``±max_cfo`` and, with ``random_phase``, a carrier
    phase uniform in ``[0, 2 pi)`` (else 0), per frame."""
    cfo = rng.uniform(-max_cfo, max_cfo, batch)
    phi0 = rng.uniform(0.0, _TWO_PI, batch)
    if not random_phase:
        phi0 = np.zeros(batch)
    return {"cfo": _f32(cfo), "phi0": _f32(phi0)}


def carrier_offset(sig: torch.Tensor, draws: Draws) -> torch.Tensor:
    """Carrier frequency offset plus phase: a unitary per-sample rotation."""
    phase = _TWO_PI * _col(sig, draws["cfo"]) * _t(sig) + _col(sig, draws["phi0"])
    return sig * _rotate(phase)


def phase_noise_draws(rng: np.random.Generator, batch: int,
                      length: int) -> Draws:
    """Standard-normal phase increments, ``(B, L)``."""
    return {"steps": _f32(rng.standard_normal((batch, length)))}


def phase_noise(sig: torch.Tensor, draws: Draws, scale: float) -> torch.Tensor:
    """Wiener-process oscillator phase noise (a random-walk phase with
    per-sample sigma ``scale``); unitary, so power-preserving."""
    pn = torch.cumsum(_on(sig, draws["steps"]) * scale, dim=-1)
    return sig * _rotate(pn)


def timing_offset_draws(rng: np.random.Generator, batch: int, max_sro: float,
                        max_jitter: float = 0.5) -> Draws:
    """A relative rate offset uniform in ``±max_sro`` and an initial
    fractional delay uniform in ``[0, max_jitter)`` samples, per frame."""
    return {"sro": _f32(rng.uniform(-max_sro, max_sro, batch)),
            "tau": _f32(rng.uniform(0.0, max_jitter, batch))}


def timing_offset(sig: torch.Tensor, draws: Draws) -> torch.Tensor:
    """Sample-rate offset and fractional timing by a Farrow resampler.

    Evaluates each frame at ``t_k = k * (1 + sro) + tau`` with the cubic
    Lagrange Farrow structure (four neighbouring taps, polynomial in the
    fractional part).  Edge samples clamp to the frame boundary; output
    power is renormalized to the input's.
    """
    n = sig.shape[-1]
    t = _t(sig) * (1.0 + _col(sig, draws["sro"])) + _col(sig, draws["tau"])
    base = torch.floor(t)
    mu = t - base                                   # fractional part, [0, 1)
    i0 = base.to(torch.int64) - 1                   # taps at i0 .. i0+3
    taps = torch.arange(4, device=sig.device)
    idx = torch.clamp(i0[:, None, :] + taps[None, :, None], 0, n - 1)
    x = torch.gather(sig[:, None, :].expand(-1, 4, -1), 2, idx)  # (B, 4, L)
    # cubic Lagrange basis in mu (the Farrow branch polynomials)
    c0 = -mu * (mu - 1.0) * (mu - 2.0) / 6.0
    c1 = (mu + 1.0) * (mu - 1.0) * (mu - 2.0) / 2.0
    c2 = -(mu + 1.0) * mu * (mu - 2.0) / 2.0
    c3 = (mu + 1.0) * mu * (mu - 1.0) / 6.0
    out = c0 * x[:, 0] + c1 * x[:, 1] + c2 * x[:, 2] + c3 * x[:, 3]
    return _match_power(out, sig)


def iq_imbalance_draws(rng: np.random.Generator, batch: int,
                       max_amp_db: float, max_phase_deg: float) -> Draws:
    """A gain mismatch uniform in ``±max_amp_db`` and a phase mismatch
    uniform in ``±max_phase_deg``, per frame."""
    return {"g_db": _f32(rng.uniform(-max_amp_db, max_amp_db, batch)),
            "phi_deg": _f32(rng.uniform(-max_phase_deg, max_phase_deg, batch))}


def iq_imbalance(sig: torch.Tensor, draws: Draws) -> torch.Tensor:
    """Receiver I/Q gain and phase mismatch: ``y = mu*x + nu*conj(x)`` with
    ``mu = (1 + g e^{j phi})/2``, ``nu = (1 - g e^{j phi})/2``.  Output
    power is renormalized to the input's."""
    g = 10.0 ** (_col(sig, draws["g_db"]) / 20.0)
    phi = torch.deg2rad(_col(sig, draws["phi_deg"]))
    rot = g * _rotate(phi)
    mu = 0.5 * (1.0 + rot)
    nu = 0.5 * (1.0 - rot)
    return _match_power(mu * sig + nu * torch.conj(sig), sig)


def multipath_fading_draws(rng: np.random.Generator, batch: int,
                           n_paths: int, n_sinusoids: int = 8) -> Draws:
    """Per frame and path: the Jakes oscillators' arrival angles and
    phases, uniform in ``[0, 2 pi)``; per frame, the line-of-sight phase."""
    shape = (batch, n_paths, n_sinusoids)
    return {"angles": _f32(rng.uniform(0.0, _TWO_PI, shape)),
            "phases": _f32(rng.uniform(0.0, _TWO_PI, shape)),
            "theta": _f32(rng.uniform(0.0, _TWO_PI, batch))}


def multipath_fading(sig: torch.Tensor, draws: Draws,
                     path_delays: Sequence[int] = (0, 1, 3),
                     path_powers: Sequence[float] = (1.0, 0.5, 0.25),
                     doppler: float = 0.01,
                     rician_k: float = 0.0) -> torch.Tensor:
    """Time-varying Rayleigh/Rician multipath with Doppler.

    Each discrete-delay path carries a Jakes sum-of-sinusoids tap process
    ``h_p(t) = sum_k exp(j(2 pi f_d t cos(a_k) + phi_k)) / sqrt(K)``;
    with ``rician_k > 0`` the first path gets a constant line-of-sight
    component at K-factor ``rician_k``.  ``path_powers`` are normalized to
    sum to one; delays are static sample shifts (frame-edge zero fill).
    Output power is renormalized to the input's.
    """
    delays = tuple(int(d) for d in path_delays)
    powers = np.asarray(path_powers, np.float32)
    powers = powers / powers.sum()
    angles, phases = _on(sig, draws["angles"]), _on(sig, draws["phases"])
    n_sinusoids = angles.shape[-1]
    t = _t(sig)
    out = torch.zeros_like(sig)
    for p, d in enumerate(delays):
        osc = _rotate(_TWO_PI * doppler * torch.cos(angles[:, p, :, None])
                      * t + phases[:, p, :, None])           # (B, K, L)
        h = osc.sum(dim=-2) / math.sqrt(n_sinusoids)
        if p == 0 and rician_k > 0.0:
            los = (math.sqrt(rician_k / (rician_k + 1.0))
                   * _rotate(_col(sig, draws["theta"])))
            h = los + h * math.sqrt(1.0 / (rician_k + 1.0))
        delayed = sig if d == 0 else torch.cat(
            [torch.zeros_like(sig[..., :d]), sig[..., :-d]], dim=-1)
        out = out + float(np.sqrt(powers[p])) * h * delayed
    return _match_power(out, sig)


# ---------------------------------------------------------------------------
# The dataset generator's host-side channel.
# ---------------------------------------------------------------------------

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
