"""Model configurations of the port: the paper's SNN
(:mod:`.saocds_amc`) and the 10 assigned language-model architectures
with their shape registry (:mod:`.registry`), as the reference's
``repro.configs`` exports them."""

from .registry import (
    ARCH_IDS,
    SHAPES,
    get_config,
    reduced_config,
    all_cells,
    cell_applicable,
)

__all__ = ["ARCH_IDS", "SHAPES", "get_config", "reduced_config", "all_cells",
           "cell_applicable"]
