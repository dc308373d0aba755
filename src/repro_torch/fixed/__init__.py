"""Fixed-point hardware-parity tier (paper §IV-C): the ``fixed`` backend.

Port of ``repro/fixed``.  Importing this package registers the ``fixed``
execution backend (int weight codes, int32 accumulation, int16 saturating
LIF membranes with shift-based leak, integer Σ-Δ encoding) with the
layer-graph registry; ``repro_torch.models.graph.get_backend`` imports it
on first use, so ``backend="fixed"`` works without an explicit import.
"""
from repro_torch.fixed import backend as _backend  # noqa: F401  (registers "fixed")
from repro_torch.fixed.encoder import (
    fixed_encode_batch,
    fixed_encode_frames,
    fixed_sigma_delta_encode,
)
from repro_torch.fixed.golden import GoldenNet, build_golden, golden_encode_frames
from repro_torch.fixed.quantize import (
    FIXED_DEFAULT_BITS,
    FixedLIF,
    FixedQuantFn,
    QuantizedLayer,
    assignment_uses_fixed,
    calibrate_step,
    derive_fixed_layer,
    fixed_logit_scale,
    lif_to_fixed,
    quantize_codes,
    serving_quant_fn,
)

__all__ = [
    "FIXED_DEFAULT_BITS",
    "FixedLIF",
    "FixedQuantFn",
    "QuantizedLayer",
    "GoldenNet",
    "assignment_uses_fixed",
    "build_golden",
    "calibrate_step",
    "derive_fixed_layer",
    "fixed_encode_batch",
    "fixed_encode_frames",
    "fixed_logit_scale",
    "fixed_sigma_delta_encode",
    "golden_encode_frames",
    "lif_to_fixed",
    "quantize_codes",
    "serving_quant_fn",
]
