"""Declarative channel scenarios: named impairment stacks over one entry point.

Port of ``repro/channel/scenario.py``.  A :class:`ChannelScenario` is a
frozen dataclass of impairment severities; :func:`apply_scenario`
composes the :mod:`repro_torch.channel.impairments` family in the GNU
Radio dynamic-channel order (timing -> fading -> carrier -> phase noise
-> IQ imbalance -> interference -> AWGN) over a batch of frames.

Randomness: a scenario run is deterministic in an integer seed.  The seed
spawns seven independent numpy streams (``SeedSequence.spawn(7)``), one
per impairment stage in the order above, whatever stages are active, so
enabling one impairment never reshuffles another's draws (the reference's
seven-way key split).  Every stage draws for the whole batch on the host
(:func:`scenario_draws`); :func:`apply_scenario_draws` then runs on the
frames' device, so the card and the CPU impair a seed's frames alike,
within rounding.  The reference's ``jax.random`` streams are not
reproduced.

The named suite (:data:`SCENARIOS`) and the eval CLI's suites
(:data:`SUITES`) are the reference's, field for field.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import struct
import zlib
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.channel.impairments import (
    awgn,
    awgn_draws,
    carrier_offset,
    carrier_offset_draws,
    interferer_tones,
    interferer_tones_draws,
    iq_imbalance,
    iq_imbalance_draws,
    multipath_fading,
    multipath_fading_draws,
    phase_noise,
    phase_noise_draws,
    timing_offset,
    timing_offset_draws,
    to_complex,
    to_iq,
)
from repro_torch.device import resolve_device

__all__ = [
    "ChannelScenario",
    "SCENARIOS",
    "SUITES",
    "STAGES",
    "get_scenario",
    "suite_scenarios",
    "scenario_draws",
    "apply_scenario_draws",
    "apply_scenario",
    "apply_scenario_np",
    "scenario_fn",
    "stable_seed",
    "make_frame_source",
]

#: The impairment stages, in channel order; one seed stream each.
STAGES = ("timing", "fading", "carrier", "phase_noise", "iq", "interferer",
          "noise")


def stable_seed(tag: str, value: float) -> int:
    """Stable 32-bit seed from a tag and a *float* (hashes the double's
    bytes, so fractional values like 0.5 and 0.9 never collide).  Shared by
    the eval harness's sweep cells and the canary monitor's SNR buckets;
    equal to the reference's."""
    return zlib.crc32(tag.encode() + struct.pack("<d", float(value)))


@dataclasses.dataclass(frozen=True)
class ChannelScenario:
    """One channel condition, declaratively.

    Zero severities switch an impairment off entirely, so
    ``ChannelScenario(name="clean", add_noise=False)`` is the identity (up
    to the unit-RMS output convention).  Frequencies are normalized to the
    sample rate.
    """

    name: str = "custom"
    # carrier / oscillator
    max_cfo: float = 0.0            # uniform CFO in ±max_cfo (cycles/sample)
    random_phase: bool = False      # uniform carrier phase in [0, 2pi)
    phase_noise_scale: float = 0.0  # per-sample phase random-walk sigma
    # timing (Farrow fractional resampler)
    max_sro: float = 0.0            # relative sample-rate offset, ±
    max_jitter: float = 0.0         # initial fractional delay, samples
    # receiver IQ imbalance
    iq_amp_db: float = 0.0          # gain mismatch, ±dB
    iq_phase_deg: float = 0.0       # phase mismatch, ±deg
    # multipath fading
    fading: str = "none"            # "none" | "rayleigh" | "rician"
    doppler: float = 0.0            # max Doppler shift (cycles/sample)
    path_delays: Tuple[int, ...] = (0,)
    path_powers: Tuple[float, ...] = (1.0,)
    rician_k: float = 0.0           # LOS K-factor (rician only)
    # co-channel interference
    sir_db: Optional[float] = None  # None -> no interferer
    interferer_f: Tuple[float, float] = (0.05, 0.45)
    n_tones: int = 1
    # thermal noise + output convention
    add_noise: bool = True          # AWGN at the requested snr_db (last)
    normalize: bool = True          # RadioML-style unit-RMS output frames

    def __post_init__(self):
        if self.fading not in ("none", "rayleigh", "rician"):
            raise ValueError(
                f"fading must be 'none', 'rayleigh' or 'rician', got "
                f"{self.fading!r}")
        if len(self.path_delays) != len(self.path_powers):
            raise ValueError(
                f"path_delays ({len(self.path_delays)}) and path_powers "
                f"({len(self.path_powers)}) must pair up")

    def active(self) -> Dict[str, bool]:
        """Which stages this scenario runs, by :data:`STAGES` name."""
        return {
            "timing": self.max_sro > 0.0 or self.max_jitter > 0.0,
            "fading": self.fading != "none",
            "carrier": self.max_cfo > 0.0 or self.random_phase,
            "phase_noise": self.phase_noise_scale > 0.0,
            "iq": self.iq_amp_db > 0.0 or self.iq_phase_deg > 0.0,
            "interferer": self.sir_db is not None,
            "noise": self.add_noise,
        }


def scenario_draws(scenario: Union[str, "ChannelScenario"], batch: int,
                   length: int, seed: int) -> Dict[str, Optional[dict]]:
    """Every active stage's draws for ``batch`` frames of ``length``
    samples, from ``seed`` (host numpy; ``None`` for an inactive stage)."""
    sc = get_scenario(scenario)
    streams = np.random.SeedSequence(int(seed) % (2 ** 31 - 1)).spawn(len(STAGES))
    rngs = dict(zip(STAGES, (np.random.default_rng(s) for s in streams)))
    make = {
        "timing": lambda r: timing_offset_draws(r, batch, sc.max_sro,
                                                sc.max_jitter),
        "fading": lambda r: multipath_fading_draws(r, batch,
                                                   len(sc.path_delays)),
        "carrier": lambda r: carrier_offset_draws(r, batch, sc.max_cfo,
                                                  sc.random_phase),
        "phase_noise": lambda r: phase_noise_draws(r, batch, length),
        "iq": lambda r: iq_imbalance_draws(r, batch, sc.iq_amp_db,
                                           sc.iq_phase_deg),
        "interferer": lambda r: interferer_tones_draws(
            r, batch, sc.interferer_f[0], sc.interferer_f[1], sc.n_tones),
        "noise": lambda r: awgn_draws(r, batch, length),
    }
    return {stage: make[stage](rngs[stage]) if on else None
            for stage, on in sc.active().items()}


def apply_scenario_draws(scenario: Union[str, "ChannelScenario"],
                         iq: torch.Tensor, snr_db,
                         draws: Dict[str, Optional[dict]]) -> torch.Tensor:
    """(B, 2, L) frames -> impaired (B, 2, L), deterministic in ``draws``,
    on ``iq``'s device.  ``snr_db`` is a scalar or one value per frame."""
    sc = get_scenario(scenario)
    on = sc.active()
    sig = to_complex(iq)
    if on["timing"]:
        sig = timing_offset(sig, draws["timing"])
    if on["fading"]:
        sig = multipath_fading(
            sig, draws["fading"], path_delays=sc.path_delays,
            path_powers=sc.path_powers, doppler=sc.doppler,
            rician_k=sc.rician_k if sc.fading == "rician" else 0.0)
    if on["carrier"]:
        sig = carrier_offset(sig, draws["carrier"])
    if on["phase_noise"]:
        sig = phase_noise(sig, draws["phase_noise"], sc.phase_noise_scale)
    if on["iq"]:
        sig = iq_imbalance(sig, draws["iq"])
    if on["interferer"]:
        sig = interferer_tones(sig, draws["interferer"], sc.sir_db)
    if on["noise"]:
        sig = awgn(sig, draws["noise"], snr_db)
    out = to_iq(sig)
    if sc.normalize:
        # the dataset generator's unit-RMS frame convention, per frame
        rms = torch.sqrt(torch.mean(out ** 2, dim=(-2, -1), keepdim=True))
        out = out / (rms * math.sqrt(2.0) + 1e-9)
    return out


def apply_scenario(scenario: Union[str, "ChannelScenario"],
                   iq: torch.Tensor, snr_db, seed: int) -> torch.Tensor:
    """Run a frame (2, L) or batch (B, 2, L) through the scenario's channel
    on ``iq``'s device; deterministic in ``seed``.  ``snr_db`` may be a
    scalar or, for a batch, one value per frame (RadioML batches mix SNRs).
    """
    sc = get_scenario(scenario)
    iq = torch.as_tensor(iq, dtype=torch.float32)
    single = iq.dim() == 2
    batch = iq[None] if single else iq
    draws = scenario_draws(sc, batch.shape[0], batch.shape[-1], seed)
    out = apply_scenario_draws(sc, batch, snr_db, draws)
    return out[0] if single else out


@functools.lru_cache(maxsize=None)
def _cached_scenario_fn(sc: ChannelScenario) -> Callable:
    return functools.partial(apply_scenario, sc)


def scenario_fn(scenario: Union[str, ChannelScenario]) -> Callable:
    """An ``(iq, snr_db, seed) -> impaired`` closure over the scenario,
    cached per scenario (frozen dataclasses hash), as the reference shares
    one jitted channel per scenario."""
    return _cached_scenario_fn(get_scenario(scenario))


def apply_scenario_np(scenario: Union[str, ChannelScenario], iq: np.ndarray,
                      snrs, seed: int, device=None) -> np.ndarray:
    """Scenario channel on numpy frames, seeded by an integer; the channel
    runs on ``device`` (the card unless ``device="cpu"``) and the impaired
    frames come back as float32 numpy.  The one place the trainer, the
    pipeline and the frame sources derive their channel draws."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(iq, np.float32), device=dev)
    snr = torch.as_tensor(np.asarray(snrs, np.float32), device=dev)
    return scenario_fn(scenario)(x, snr, seed).cpu().numpy()


# ---------------------------------------------------------------------------
# The named suite.
# ---------------------------------------------------------------------------

SCENARIOS: Dict[str, ChannelScenario] = {
    sc.name: sc for sc in (
        # the dataset's own channel family (the legacy channel's twin)
        ChannelScenario(name="static_awgn", max_cfo=0.01, random_phase=True,
                        phase_noise_scale=2e-3),
        ChannelScenario(name="urban_fading", fading="rayleigh",
                        path_delays=(0, 2, 5), path_powers=(1.0, 0.6, 0.3),
                        doppler=5e-3, max_cfo=0.01, random_phase=True,
                        phase_noise_scale=2e-3),
        ChannelScenario(name="doppler_drift", fading="rayleigh",
                        path_delays=(0, 1), path_powers=(1.0, 0.4),
                        doppler=0.03, max_cfo=0.02, random_phase=True,
                        max_sro=1e-3, max_jitter=0.25,
                        phase_noise_scale=2e-3),
        ChannelScenario(name="iq_impaired", iq_amp_db=1.5, iq_phase_deg=8.0,
                        max_cfo=5e-3, random_phase=True,
                        phase_noise_scale=3e-3),
        ChannelScenario(name="adjacent_interferer", sir_db=8.0,
                        interferer_f=(0.1, 0.45), max_cfo=0.01,
                        random_phase=True),
        ChannelScenario(name="rician_los", fading="rician", rician_k=4.0,
                        path_delays=(0, 3), path_powers=(1.0, 0.3),
                        doppler=2e-3, random_phase=True),
        ChannelScenario(name="timing_drift", max_sro=2e-3, max_jitter=0.5,
                        max_cfo=0.01, random_phase=True,
                        phase_noise_scale=2e-3),
    )
}

# Scenario suites (eval CLI --suite): "default" is the named set, "all"
# adds the LOS + timing variants, "quick" is the smoke pair.
SUITES: Dict[str, Tuple[str, ...]] = {
    "default": ("static_awgn", "urban_fading", "doppler_drift",
                "iq_impaired", "adjacent_interferer"),
    "all": tuple(SCENARIOS),
    "quick": ("static_awgn", "doppler_drift"),
}


def get_scenario(scenario: Union[str, ChannelScenario]) -> ChannelScenario:
    """Resolve a scenario by name (or pass a ChannelScenario through)."""
    if isinstance(scenario, ChannelScenario):
        return scenario
    try:
        return SCENARIOS[scenario]
    except KeyError:
        raise ValueError(
            f"unknown channel scenario {scenario!r}; named scenarios: "
            f"{sorted(SCENARIOS)}") from None


def suite_scenarios(suite: str) -> Tuple[ChannelScenario, ...]:
    """Resolve a suite name (or comma-joined scenario names) to scenarios."""
    if suite in SUITES:
        names = SUITES[suite]
    else:
        names = tuple(s.strip() for s in suite.split(",") if s.strip())
        if not names:
            raise ValueError(
                f"empty scenario suite {suite!r}; suites: {sorted(SUITES)}")
    return tuple(get_scenario(n) for n in names)


# ---------------------------------------------------------------------------
# Frame-source adapter (deploy.CanaryMonitor drift injection).
# ---------------------------------------------------------------------------

def make_frame_source(scenario: Union[str, ChannelScenario],
                      frame_len: int = 128,
                      classes: Optional[Tuple[int, ...]] = None,
                      device=None) -> Callable:
    """A ``(seed, n, snr_db) -> (iq, labels)`` source of impaired frames.

    Drop-in for :class:`repro_torch.deploy.CanaryMonitor`'s
    ``frame_source``: clean modulated RadioML frames are run through the
    scenario's channel at the requested SNR on ``device`` (the card unless
    ``device="cpu"``).  Deterministic in ``(seed, scenario)``.
    """
    from repro_torch.data.radioml import generate_batch

    sc = get_scenario(scenario)
    dev = resolve_device(device)

    def source(seed: int, n: int, snr_db: float):
        iq, labels, snrs = generate_batch(seed, n, snr_db=snr_db,
                                          classes=classes,
                                          frame_len=frame_len,
                                          apply_channel=False)
        return apply_scenario_np(sc, iq, snrs, seed, device=dev), labels

    return source
