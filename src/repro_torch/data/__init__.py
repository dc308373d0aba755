"""Data substrate of the port: the synthetic RadioML 2016.10A generator,
the Σ-Δ encoders and the background batch pipeline."""

from .pipeline import (
    SpikeBatchPipeline,
    sigma_delta_encode_batch,
    sigma_delta_encode_np,
)
from .radioml import (
    MODULATIONS,
    N_CLASSES,
    SNR_GRID,
    RadioMLDataset,
    generate_batch,
    generate_sample,
)

__all__ = ["MODULATIONS", "N_CLASSES", "SNR_GRID", "generate_sample",
           "generate_batch", "RadioMLDataset", "SpikeBatchPipeline",
           "sigma_delta_encode_np", "sigma_delta_encode_batch"]
