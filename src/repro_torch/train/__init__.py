"""Training substrate of the port: optimizers, pruning, LSQ quantization,
checkpointing, and the surrogate-gradient BPTT trainer."""

from .checkpoint import CheckpointManager
from .lsq import dequantize, init_lsq_scales, lsq_fake_quant, quantize_to_int
from .optimizer import adamw, apply_updates, clip_by_global_norm, sgd
from .pruning import (
    magnitude_masks,
    make_mask_pytree,
    mask_density,
    target_density_at,
)
from .trainer import SNNTrainer, TrainerConfig

__all__ = ["adamw", "sgd", "clip_by_global_norm", "apply_updates",
           "target_density_at", "magnitude_masks", "make_mask_pytree",
           "mask_density", "lsq_fake_quant", "init_lsq_scales",
           "quantize_to_int", "dequantize", "CheckpointManager",
           "SNNTrainer", "TrainerConfig"]
