"""Scenario robustness evaluation: (scenario x SNR x backend) sweeps.

:func:`evaluate_robustness` runs plan-compiled batched forwards over the
:mod:`repro_torch.channel` scenario suite and an SNR grid, producing
per-modulation confusion matrices and a per-SNR accuracy surface as one
JSON-serializable report.  CLI: ``python -m repro_torch.launch.eval``.
"""

from .robustness import (
    RobustnessConfig,
    evaluate_robustness,
    format_report,
    stable_cell_seed,
)

__all__ = [
    "RobustnessConfig",
    "evaluate_robustness",
    "format_report",
    "stable_cell_seed",
]
