"""The frame pool: synthetic RadioML-style I/Q frames from a seed.

A frozen copy of the port's generator (``repro_torch/data/radioml.py``),
vectorized over frames so that a pool of thousands is made in a fraction of
a second, widened to any frame length and to two modulation sets:

* ``"radioml2016.10a"`` (the default): the 2016.10A set's 11 modulations
  (RRC-shaped PSK/PAM/QAM, Gaussian and continuous-phase FSK, an AR(2)
  audio source for WBFM and AM);
* ``"radioml2018.01a"``: the 2018.01A set's 24, in the dataset's class
  order (``FRAME_SETS``).  OOK and ASK are unipolar amplitude levels,
  16/32PSK and the square QAMs are as above, 32QAM and 128QAM cross
  constellations, all through the same RRC shaping; OQPSK is QPSK with Q
  delayed half a symbol; GMSK is the FSK path with a Gaussian filter of
  BT 0.3 (modulation index 0.5, as CPFSK); FM is the WBFM path; the AM
  variants are the audio source with the carrier (WC, index 0.8) or
  without it (SC), double sideband or upper sideband.  The APSK ring
  counts follow DVB-S2/S2X (16APSK 4+12, 32APSK 4+12+16); assumed, since
  the dataset's generator is not public in this detail: the ring radii
  (16APSK 1 : 2.85, 32APSK 1 : 2.84 : 5.27, DVB-S2's at rate 3/4), the
  64APSK layout 8+16+20+20 at radii 1 : 2.2 : 3.6 : 5.2 and the 128APSK
  layout 16+16+16+16+16+48 at radii 1 : 1.6 : 2.2 : 2.8 : 3.4 : 4.2, each
  ring's first point at half its angular step.

Both sets share the channel (random carrier offset and phase, phase noise,
AWGN at the frame's SNR) and the unit-energy scaling.  The draws are not
the program's, so the frames are not bit-equal to its generator's; they
need not be.  At the default length and set the pool is the one this
generator has always made: the same draws in the same order.

Every seed gets the same set of labels and SNRs (a balanced grid, frame
``i`` is modulation ``i % M`` at SNR ``grid[(i // M) % len(grid)]`` for a
set of ``M`` modulations); the seed draws the symbols, sources and channel.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

FRAME_SETS = {
    "radioml2016.10a": ("BPSK", "QPSK", "8PSK", "PAM4", "QAM16", "QAM64",
                        "GFSK", "CPFSK", "WBFM", "AM-DSB", "AM-SSB"),
    "radioml2018.01a": ("OOK", "4ASK", "8ASK", "BPSK", "QPSK", "8PSK", "16PSK",
                        "32PSK", "16APSK", "32APSK", "64APSK", "128APSK",
                        "16QAM", "32QAM", "64QAM", "128QAM", "256QAM",
                        "AM-SSB-WC", "AM-SSB-SC", "AM-DSB-WC", "AM-DSB-SC",
                        "FM", "GMSK", "OQPSK"),
}
DEFAULT_SET = "radioml2016.10a"
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


def _ask(m: int) -> np.ndarray:
    """Unipolar amplitude levels 0 .. m-1 (OOK is m = 2)."""
    pts = np.arange(m, dtype=float)
    return (pts / np.sqrt((pts ** 2).mean())).astype(complex)


def _cross_qam(m: int) -> np.ndarray:
    """32- or 128-point cross QAM: the square grid of side 6 or 12 with a
    square of side 1 or 2 cut from each corner."""
    side = {32: 6, 128: 12}[m]
    cut = side // 6
    re, im = np.meshgrid(np.arange(side), np.arange(side))
    corner = ((np.minimum(re, side - 1 - re) < cut)
              & (np.minimum(im, side - 1 - im) < cut))
    pts = ((2 * re - side + 1) + 1j * (2 * im - side + 1))[~corner]
    return pts / np.sqrt((np.abs(pts) ** 2).mean())


def _apsk(rings, radii) -> np.ndarray:
    pts = np.concatenate([r * np.exp(1j * (2 * np.pi * np.arange(n) / n + np.pi / n))
                          for n, r in zip(rings, radii)])
    return pts / np.sqrt((np.abs(pts) ** 2).mean())


CONSTELLATIONS = {
    "BPSK": _psk(2), "QPSK": _psk(4), "8PSK": _psk(8),
    "PAM4": _pam(4), "QAM16": _qam(16), "QAM64": _qam(64),
    "OOK": _ask(2), "4ASK": _ask(4), "8ASK": _ask(8),
    "16PSK": _psk(16), "32PSK": _psk(32),
    "16APSK": _apsk((4, 12), (1.0, 2.85)),
    "32APSK": _apsk((4, 12, 16), (1.0, 2.84, 5.27)),
    "64APSK": _apsk((8, 16, 20, 20), (1.0, 2.2, 3.6, 5.2)),
    "128APSK": _apsk((16, 16, 16, 16, 16, 48), (1.0, 1.6, 2.2, 2.8, 3.4, 4.2)),
    "16QAM": _qam(16), "32QAM": _cross_qam(32), "64QAM": _qam(64),
    "128QAM": _cross_qam(128), "256QAM": _qam(256),
}
# the FSK schemes, each with its Gaussian filter's BT (None: CPFSK, unfiltered)
FSK = {"GFSK": 0.35, "CPFSK": None, "GMSK": 0.3}


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


def _oqpsk(rng, m: int, n: int) -> np.ndarray:
    """QPSK whose Q lags its I by half a symbol."""
    sig = _linear(rng, "QPSK", m, n + SPS // 2)
    return sig.real[:, SPS // 2:] + 1j * sig.imag[:, :n]


def _fsk(rng, scheme: str, m: int, n: int) -> np.ndarray:
    n_sym = n // SPS + 8
    bits = rng.integers(0, 2, (m, n_sym)) * 2.0 - 1.0
    freq = np.repeat(bits, SPS, axis=1)
    if FSK[scheme] is not None:
        freq = freq @ _same_conv_matrix(_gaussian_taps(FSK[scheme]), freq.shape[1])
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
    if scheme in ("WBFM", "FM"):
        return np.exp(1j * 2 * np.pi * 0.4 * np.cumsum(x, axis=1))
    if scheme in ("AM-DSB", "AM-DSB-WC"):
        return (1.0 + 0.8 * x).astype(complex)
    if scheme == "AM-DSB-SC":
        return x.astype(complex)
    h = np.zeros(n)               # AM-SSB: upper sideband (Hilbert)
    h[0] = 1
    h[n // 2] = 1
    h[1:n // 2] = 2
    ssb = np.fft.ifft(np.fft.fft(x, axis=1) * h, axis=1)
    return 1.0 + 0.8 * ssb if scheme == "AM-SSB-WC" else ssb


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


def make_pool(seed: int, n_frames: int, snr_db: Sequence[int],
              length: int = FRAME_LEN, frames: str = DEFAULT_SET
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(iq (n, 2, length) float32, labels (n,), snrs (n,))``: a balanced
    grid of the set ``frames``' modulations and SNRs, the content drawn
    from ``seed``."""
    if frames not in FRAME_SETS:
        raise ValueError(f"unknown frame set {frames!r}; the generator has "
                         f"{sorted(FRAME_SETS)}")
    schemes = FRAME_SETS[frames]
    grid = np.asarray(list(snr_db), dtype=np.float64)
    idx = np.arange(n_frames)
    labels = idx % len(schemes)
    snrs = grid[(idx // len(schemes)) % len(grid)]
    rng = np.random.default_rng(seed)
    iq = np.empty((n_frames, 2, length), np.float32)
    for c, scheme in enumerate(schemes):
        rows = np.nonzero(labels == c)[0]
        if not len(rows):
            continue
        if scheme in CONSTELLATIONS:
            sig = _linear(rng, scheme, len(rows), length)
        elif scheme in FSK:
            sig = _fsk(rng, scheme, len(rows), length)
        elif scheme == "OQPSK":
            sig = _oqpsk(rng, len(rows), length)
        else:
            sig = _analog(rng, scheme, len(rows), length)
        sig = _channel(rng, sig, snrs[rows])
        out = np.stack([sig.real, sig.imag], axis=1).astype(np.float32)
        energy = np.sqrt(np.mean(out ** 2, axis=(1, 2), keepdims=True))
        iq[rows] = out / (energy * np.sqrt(2) + 1e-9)
    return iq, labels.astype(np.int32), snrs.astype(np.float32)
