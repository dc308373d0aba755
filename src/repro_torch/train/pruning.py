"""L1-unstructured magnitude pruning masks (paper §IV-C.1).

Port of ``magnitude_masks`` and ``make_mask_pytree`` from
``repro/train/pruning.py``; the three-phase pruning schedule waits for the
training slice.
"""
from __future__ import annotations

from typing import Dict

import torch

__all__ = ["magnitude_masks", "make_mask_pytree"]


def magnitude_masks(w: torch.Tensor, density: float) -> torch.Tensor:
    """Keep the top-``density`` fraction of |w| (ties at the threshold kept)."""
    if density >= 1.0:
        return torch.ones_like(w, dtype=torch.float32)
    n = w.numel()
    k = max(1, int(round(n * density)))
    flat = w.abs().reshape(-1)
    thresh = torch.sort(flat).values[n - k]   # k-th largest magnitude
    return (w.abs() >= thresh).to(torch.float32)


def make_mask_pytree(params: Dict, densities: Dict[str, float] | float) -> Dict:
    """Masks for ``{'conv': [{'w', ...}], 'fc': [...]}``; ``densities`` is a
    scalar or a per-layer dict keyed 'conv1'..., 'fc1'..."""
    def dens(name: str) -> float:
        if isinstance(densities, dict):
            return float(densities[name])
        return float(densities)

    masks: Dict[str, list] = {"conv": [], "fc": []}
    for i, layer in enumerate(params["conv"]):
        masks["conv"].append(magnitude_masks(layer["w"], dens(f"conv{i + 1}")))
    for i, layer in enumerate(params["fc"]):
        masks["fc"].append(magnitude_masks(layer["w"], dens(f"fc{i + 1}")))
    return masks
