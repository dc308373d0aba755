"""The frame pool: synthetic RadioML 2016.10A-style I/Q frames from a seed.

A frozen copy of the port's generator (``repro_torch/data/radioml.py``),
vectorized over frames so that a pool of thousands is made in a fraction of
a second: the same 11 modulations (RRC-shaped PSK/PAM/QAM, Gaussian and
continuous-phase FSK, an AR(2) audio source for WBFM and AM), the same
channel (random carrier offset and phase, phase noise, AWGN at the frame's
SNR) and the same unit-energy scaling.  The draws are not the program's, so
the frames are not bit-equal to its generator's; they need not be.

Every seed gets the same set of labels and SNRs (a balanced grid, frame
``i`` is modulation ``i % 11`` at SNR ``grid[(i // 11) % len(grid)]``);
the seed draws the symbols, sources and channel.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

MODULATIONS = ("BPSK", "QPSK", "8PSK", "PAM4", "QAM16", "QAM64", "GFSK",
               "CPFSK", "WBFM", "AM-DSB", "AM-SSB")
FRAME_LEN = 128
SPS = 8


def _rrc_taps(beta: float = 0.35, span: int = 8, sps: int = SPS) -> np.ndarray:
    n = span * sps
    t = np.arange(-n // 2, n // 2 + 1) / sps
    near_zero = np.abs(t) < 1e-9
    singular = np.abs(np.abs(4 * beta * t) - 1.0) < 1e-9
    with np.errstate(divide="ignore", invalid="ignore"):
        num = (np.sin(np.pi * t * (1 - beta))
               + 4 * beta * t * np.cos(np.pi * t * (1 + beta)))
        taps = num / (np.pi * t * (1 - (4 * beta * t) ** 2))
    taps = np.where(singular, (beta / np.sqrt(2)) * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta))), taps)
    taps = np.where(near_zero, 1.0 - beta + 4 * beta / np.pi, taps)
    return taps / np.sqrt(np.sum(taps ** 2))


def _gaussian_taps(bt: float = 0.35, span: int = 4, sps: int = SPS) -> np.ndarray:
    t = np.arange(-span * sps // 2, span * sps // 2 + 1) / sps
    sigma = np.sqrt(np.log(2)) / (2 * np.pi * bt)
    taps = np.exp(-(t ** 2) / (2 * sigma ** 2))
    return taps / taps.sum()


def _psk(m: int) -> np.ndarray:
    k = np.arange(m)
    return np.exp(1j * (2 * np.pi * k / m + np.pi / m))


def _qam(m: int) -> np.ndarray:
    side = int(np.sqrt(m))
    re, im = np.meshgrid(np.arange(side), np.arange(side))
    pts = ((2 * re - side + 1) + 1j * (2 * im - side + 1)).ravel()
    return pts / np.sqrt((np.abs(pts) ** 2).mean())


def _pam(m: int) -> np.ndarray:
    pts = 2 * np.arange(m) - m + 1
    return (pts / np.sqrt((pts ** 2).mean())).astype(complex)


CONSTELLATIONS = {"BPSK": _psk(2), "QPSK": _psk(4), "8PSK": _psk(8),
                  "PAM4": _pam(4), "QAM16": _qam(16), "QAM64": _qam(64)}


def _same_conv_matrix(taps: np.ndarray, n_in: int) -> np.ndarray:
    """(n_in, n_in) matrix M with ``x @ M == np.convolve(x, taps, "same")``
    for every row x of length n_in (len(taps) odd, at most n_in)."""
    k = len(taps)
    # d: tap index linking input position i (rows) to output position j
    d = np.arange(n_in)[None, :] + (k - 1) // 2 - np.arange(n_in)[:, None]
    return np.where((d >= 0) & (d < k), taps[np.clip(d, 0, k - 1)], 0.0)


def _linear(rng, scheme: str, m: int, n: int) -> np.ndarray:
    const = CONSTELLATIONS[scheme]
    rrc = _rrc_taps()
    n_sym = n // SPS + len(rrc) // SPS + 4
    syms = const[rng.integers(0, len(const), (m, n_sym))]
    # the symbols upsampled by SPS (zeros between), RRC-shaped: only every
    # SPS-th input row of the shaping matrix meets a non-zero sample
    start = len(rrc) // 2
    shaping = _same_conv_matrix(rrc, n_sym * SPS)[::SPS, start:start + n]
    return syms @ shaping


def _fsk(rng, scheme: str, m: int, n: int) -> np.ndarray:
    n_sym = n // SPS + 8
    bits = rng.integers(0, 2, (m, n_sym)) * 2.0 - 1.0
    freq = np.repeat(bits, SPS, axis=1)
    if scheme == "GFSK":
        freq = freq @ _same_conv_matrix(_gaussian_taps(), freq.shape[1])
    phase = np.cumsum(freq, axis=1) * np.pi * 0.5 / SPS
    return np.exp(1j * phase)[:, :n]


def _audio(rng, m: int, n: int) -> np.ndarray:
    w = rng.normal(size=(m, n + 64))
    x = np.zeros_like(w)
    for i in range(2, w.shape[1]):
        x[:, i] = w[:, i] + 1.6 * x[:, i - 1] - 0.72 * x[:, i - 2]
    x = x[:, 64:]
    return x / (np.max(np.abs(x), axis=1, keepdims=True) + 1e-9)


def _analog(rng, scheme: str, m: int, n: int) -> np.ndarray:
    x = _audio(rng, m, n)
    if scheme == "WBFM":
        return np.exp(1j * 2 * np.pi * 0.4 * np.cumsum(x, axis=1))
    if scheme == "AM-DSB":
        return (1.0 + 0.8 * x).astype(complex)
    h = np.zeros(n)               # AM-SSB: upper sideband (Hilbert)
    h[0] = 1
    h[n // 2] = 1
    h[1:n // 2] = 2
    return np.fft.ifft(np.fft.fft(x, axis=1) * h, axis=1)


def _channel(rng, sig: np.ndarray, snr_db: np.ndarray) -> np.ndarray:
    m, n = sig.shape
    cfo = rng.uniform(-0.01, 0.01, (m, 1))
    phi0 = rng.uniform(0, 2 * np.pi, (m, 1))
    sig = sig * np.exp(1j * (2 * np.pi * cfo * np.arange(n) + phi0))
    sig = sig * np.exp(1j * np.cumsum(rng.normal(scale=2e-3, size=(m, n)), axis=1))
    sig = sig / np.sqrt(np.mean(np.abs(sig) ** 2, axis=1, keepdims=True) + 1e-12)
    p_noise = 10 ** (-snr_db[:, None] / 10)
    noise = (rng.normal(size=(m, n)) + 1j * rng.normal(size=(m, n))) * np.sqrt(p_noise / 2)
    return sig + noise


def make_pool(seed: int, n_frames: int, snr_db: Sequence[int]
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(iq (n, 2, 128) float32, labels (n,), snrs (n,))``: a balanced
    grid of modulations and SNRs, the content drawn from ``seed``."""
    grid = np.asarray(list(snr_db), dtype=np.float64)
    idx = np.arange(n_frames)
    labels = idx % len(MODULATIONS)
    snrs = grid[(idx // len(MODULATIONS)) % len(grid)]
    rng = np.random.default_rng(seed)
    iq = np.empty((n_frames, 2, FRAME_LEN), np.float32)
    for c, scheme in enumerate(MODULATIONS):
        rows = np.nonzero(labels == c)[0]
        if not len(rows):
            continue
        if scheme in CONSTELLATIONS:
            sig = _linear(rng, scheme, len(rows), FRAME_LEN)
        elif scheme in ("GFSK", "CPFSK"):
            sig = _fsk(rng, scheme, len(rows), FRAME_LEN)
        else:
            sig = _analog(rng, scheme, len(rows), FRAME_LEN)
        sig = _channel(rng, sig, snrs[rows])
        out = np.stack([sig.real, sig.imag], axis=1).astype(np.float32)
        energy = np.sqrt(np.mean(out ** 2, axis=(1, 2), keepdims=True))
        iq[rows] = out / (energy * np.sqrt(2) + 1e-9)
    return iq, labels.astype(np.int32), snrs.astype(np.float32)
