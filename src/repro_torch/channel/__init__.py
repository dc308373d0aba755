"""RF channel-impairment simulation of the port.

Seed-deterministic impairments (:mod:`.impairments`), each a host-side
draw and a torch apply, composed into declarative named
:class:`ChannelScenario` stacks (:mod:`.scenario`) with one entry point,
:func:`apply_scenario`, that runs on the frames' device; plus
:func:`make_frame_source`, the adapter that lets
:class:`repro_torch.deploy.CanaryMonitor` shadow-evaluate under injected
channel drift.
"""

from .impairments import (
    avg_power,
    awgn,
    awgn_draws,
    carrier_offset,
    carrier_offset_draws,
    interferer_tones,
    interferer_tones_draws,
    iq_imbalance,
    iq_imbalance_draws,
    legacy_awgn_channel,
    multipath_fading,
    multipath_fading_draws,
    normalize_power,
    phase_noise,
    phase_noise_draws,
    timing_offset,
    timing_offset_draws,
    to_complex,
    to_iq,
)
from .scenario import (
    SCENARIOS,
    SUITES,
    ChannelScenario,
    apply_scenario,
    apply_scenario_draws,
    apply_scenario_np,
    get_scenario,
    make_frame_source,
    scenario_draws,
    scenario_fn,
    stable_seed,
    suite_scenarios,
)

__all__ = [
    "ChannelScenario",
    "SCENARIOS",
    "SUITES",
    "get_scenario",
    "suite_scenarios",
    "apply_scenario",
    "apply_scenario_np",
    "scenario_fn",
    "stable_seed",
    "make_frame_source",
    "to_complex",
    "to_iq",
    "avg_power",
    "normalize_power",
    "awgn",
    "carrier_offset",
    "phase_noise",
    "timing_offset",
    "iq_imbalance",
    "multipath_fading",
    "interferer_tones",
    "legacy_awgn_channel",
    # the port's draw / apply split
    "scenario_draws",
    "apply_scenario_draws",
    "awgn_draws",
    "carrier_offset_draws",
    "phase_noise_draws",
    "timing_offset_draws",
    "iq_imbalance_draws",
    "multipath_fading_draws",
    "interferer_tones_draws",
]
