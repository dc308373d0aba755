"""Synthetic RadioML 2016.10A-equivalent dataset (paper §IV-A).

The original dataset [13] is generated with GNU Radio: 11 modulation schemes
(8 digital, 3 analog), 128-sample complex baseband frames, AWGN SNRs from
-20 to 18 dB in 2 dB steps.  It is not redistributable here, so we implement
the generator: proper constellation mapping + root-raised-cosine pulse
shaping for linear digital schemes, Gaussian/continuous-phase frequency
modulation for (G/CP)FSK, an audio-like AR source for the analog schemes,
and a channel with AWGN, random carrier frequency/phase offset and timing
jitter — the same impairment family GNU Radio's dynamic channel model
applies.

All generation is vectorized numpy on the host; every sample is
deterministic in (seed, index).

Port of ``repro/data/radioml.py``: the same numpy, so every array is
bit-equal to the reference's for the same arguments.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, Optional, Tuple

import numpy as np

from repro_torch.channel.impairments import legacy_awgn_channel

__all__ = [
    "MODULATIONS",
    "N_CLASSES",
    "SNR_GRID",
    "generate_sample",
    "generate_batch",
    "RadioMLDataset",
]

MODULATIONS = (
    "BPSK", "QPSK", "8PSK", "PAM4", "QAM16", "QAM64", "GFSK", "CPFSK",  # digital
    "WBFM", "AM-DSB", "AM-SSB",                                         # analog
)
N_CLASSES = len(MODULATIONS)
SNR_GRID = tuple(range(-20, 20, 2))

FRAME_LEN = 128
SPS = 8  # samples per symbol for linear digital modulations


# ---------------------------------------------------------------------------
# Pulse shaping
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _rrc_taps(beta: float = 0.35, span: int = 8, sps: int = SPS) -> np.ndarray:
    """Root-raised-cosine filter taps (vectorized, cached per parameter set).

    The closed form has two removable singularities — t = 0 and
    |4*beta*t| = 1 — handled by ``np.where`` over the same formulas the old
    per-tap loop branched on (elementwise identical, so bit-equal).  The
    cache returns one read-only array per (beta, span, sps): tap
    construction never re-runs per generated batch.
    """
    n = span * sps
    t = (np.arange(-n // 2, n // 2 + 1)) / sps
    near_zero = np.abs(t) < 1e-9
    singular = np.abs(np.abs(4 * beta * t) - 1.0) < 1e-9
    with np.errstate(divide="ignore", invalid="ignore"):
        num = np.sin(np.pi * t * (1 - beta)) + 4 * beta * t * np.cos(np.pi * t * (1 + beta))
        den = np.pi * t * (1 - (4 * beta * t) ** 2)
        taps = num / den
    taps = np.where(
        singular,
        (beta / np.sqrt(2)) * (
            (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
            + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta))
        ),
        taps,
    )
    taps = np.where(near_zero, 1.0 - beta + 4 * beta / np.pi, taps)
    taps = taps / np.sqrt(np.sum(taps**2))
    taps.flags.writeable = False  # shared across callers via the cache
    return taps


_RRC = _rrc_taps()

_GAUSS_BT = 0.35


@functools.lru_cache(maxsize=None)
def _gaussian_taps(bt: float = _GAUSS_BT, span: int = 4, sps: int = SPS) -> np.ndarray:
    t = np.arange(-span * sps // 2, span * sps // 2 + 1) / sps
    sigma = np.sqrt(np.log(2)) / (2 * np.pi * bt)
    taps = np.exp(-(t**2) / (2 * sigma**2))
    taps = taps / taps.sum()
    taps.flags.writeable = False
    return taps


_GAUSS = _gaussian_taps()

# ---------------------------------------------------------------------------
# Constellations
# ---------------------------------------------------------------------------

def _psk_points(m: int) -> np.ndarray:
    k = np.arange(m)
    return np.exp(1j * (2 * np.pi * k / m + np.pi / m))


def _qam_points(m: int) -> np.ndarray:
    side = int(np.sqrt(m))
    re, im = np.meshgrid(np.arange(side), np.arange(side))
    pts = (2 * re - side + 1) + 1j * (2 * im - side + 1)
    pts = pts.ravel()
    return pts / np.sqrt((np.abs(pts) ** 2).mean())


def _pam_points(m: int) -> np.ndarray:
    pts = 2 * np.arange(m) - m + 1
    return (pts / np.sqrt((pts**2).mean())).astype(complex)


_CONSTELLATIONS = {
    "BPSK": _psk_points(2),
    "QPSK": _psk_points(4),
    "8PSK": _psk_points(8),
    "PAM4": _pam_points(4),
    "QAM16": _qam_points(16),
    "QAM64": _qam_points(64),
}

# ---------------------------------------------------------------------------
# Sources
# ---------------------------------------------------------------------------

def _audio_like(rng: np.random.Generator, n: int) -> np.ndarray:
    """Speech-like lowpass AR(2) source, normalized to unit peak."""
    w = rng.normal(size=n + 64)
    x = np.zeros_like(w)
    a1, a2 = 1.6, -0.72  # poles well inside unit circle, lowpass
    for i in range(2, len(w)):
        x[i] = w[i] + a1 * x[i - 1] + a2 * x[i - 2]
    x = x[64:]
    return x / (np.max(np.abs(x)) + 1e-9)


def _modulate_linear(rng: np.random.Generator, scheme: str, n: int) -> np.ndarray:
    const = _CONSTELLATIONS[scheme]
    n_sym = n // SPS + len(_RRC) // SPS + 4
    syms = const[rng.integers(0, len(const), n_sym)]
    up = np.zeros(n_sym * SPS, dtype=complex)
    up[::SPS] = syms
    shaped = np.convolve(up, _RRC, mode="same")
    start = len(_RRC) // 2
    return shaped[start : start + n]


def _modulate_fsk(rng: np.random.Generator, scheme: str, n: int) -> np.ndarray:
    n_sym = n // SPS + 8
    bits = rng.integers(0, 2, n_sym) * 2.0 - 1.0
    freq = np.repeat(bits, SPS)
    if scheme == "GFSK":
        freq = np.convolve(freq, _GAUSS, mode="same")
    h = 0.5  # modulation index
    phase = np.cumsum(freq) * np.pi * h / SPS
    sig = np.exp(1j * phase)
    return sig[:n]


def _modulate_analog(rng: np.random.Generator, scheme: str, n: int) -> np.ndarray:
    x = _audio_like(rng, n)
    if scheme == "WBFM":
        kf = 0.4
        phase = 2 * np.pi * kf * np.cumsum(x)
        return np.exp(1j * phase)
    if scheme == "AM-DSB":
        m = 0.8
        return (1.0 + m * x).astype(complex)
    if scheme == "AM-SSB":
        # upper sideband via discrete Hilbert transform
        X = np.fft.fft(x)
        h = np.zeros(n)
        h[0] = 1
        if n % 2 == 0:
            h[n // 2] = 1
            h[1 : n // 2] = 2
        else:
            h[1 : (n + 1) // 2] = 2
        analytic = np.fft.ifft(X * h)
        return analytic
    raise ValueError(scheme)


# ---------------------------------------------------------------------------
# Channel
# ---------------------------------------------------------------------------

# The channel is owned by repro_torch.channel (a numpy copy of the
# reference's legacy channel); this alias keeps the generator's call sites.
_apply_channel = legacy_awgn_channel


def generate_sample(
    seed: int, modulation: str, snr_db: float, frame_len: int = FRAME_LEN,
    apply_channel: bool = True,
) -> np.ndarray:
    """One (2, frame_len) float32 I/Q frame, deterministic in seed.

    ``apply_channel=False`` yields the clean modulated baseband (no AWGN /
    CFO / phase noise), for a scenario channel to impair later.
    The rng draw order is unchanged either way, so the underlying symbol
    stream for a given seed is identical clean and impaired.
    """
    rng = np.random.default_rng(seed)
    if modulation in _CONSTELLATIONS:
        sig = _modulate_linear(rng, modulation, frame_len)
    elif modulation in ("GFSK", "CPFSK"):
        sig = _modulate_fsk(rng, modulation, frame_len)
    else:
        sig = _modulate_analog(rng, modulation, frame_len)
    if apply_channel:
        sig = _apply_channel(rng, sig, snr_db)
    out = np.stack([sig.real, sig.imag]).astype(np.float32)
    # match RadioML's roughly unit-energy frames
    return out / (np.sqrt(np.mean(out**2)) * np.sqrt(2) + 1e-9)


def generate_batch(
    seed: int,
    batch: int,
    snr_db: Optional[float] = None,
    classes: Optional[Tuple[int, ...]] = None,
    frame_len: int = FRAME_LEN,
    apply_channel: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (iq (B, 2, L) f32, labels (B,) i32, snrs (B,) f32).

    With ``apply_channel=False`` the frames are clean modulated baseband
    (``snrs`` still names each frame's *intended* operating SNR, for the
    scenario channel to realize later).
    """
    rng = np.random.default_rng(seed)
    cls_pool = np.asarray(classes if classes is not None else range(N_CLASSES))
    labels = cls_pool[rng.integers(0, len(cls_pool), batch)]
    snrs = (
        np.full(batch, snr_db, dtype=np.float32)
        if snr_db is not None
        else np.asarray(rng.choice(SNR_GRID, batch), dtype=np.float32)
    )
    iq = np.stack([
        generate_sample(int(seed * 1_000_003 + i), MODULATIONS[labels[i]],
                        float(snrs[i]), frame_len, apply_channel)
        for i in range(batch)
    ])
    return iq.astype(np.float32), labels.astype(np.int32), snrs


@dataclasses.dataclass
class RadioMLDataset:
    """Deterministic infinite stream of (iq, label, snr) batches.

    ``apply_channel=False`` streams clean modulated frames for consumers
    that run their own channel scenario.
    """

    batch_size: int
    seed: int = 0
    snr_db: Optional[float] = None  # None -> uniform over the SNR grid
    frame_len: int = FRAME_LEN
    apply_channel: bool = True

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield generate_batch(
                self.seed + step, self.batch_size, self.snr_db,
                frame_len=self.frame_len, apply_channel=self.apply_channel,
            )
            step += 1
