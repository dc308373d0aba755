"""L1-unstructured pruning with the paper's 3-phase schedule (§IV-C.1).

Port of ``repro/train/pruning.py``.  Over training, the first 20 % of
steps train densely, the middle 60 % prune the smallest-magnitude weights
toward the target density, the final 20 % fine-tune with the mask frozen.
Per-layer target densities are supported (Table V's "25-20-15-20-25"
style configurations).  The ramp inside the pruning phase is the cubic
schedule of Zhu & Gupta (2017).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

__all__ = ["target_density_at", "magnitude_masks", "block_magnitude_masks",
           "make_mask_pytree", "mask_density"]


def target_density_at(step: int, total_steps: int, final_density: float,
                      phases: Sequence[float] = (0.2, 0.6, 0.2)) -> float:
    """Current target density under the 20/60/20 three-phase schedule."""
    warm = phases[0] * total_steps
    prune_end = (phases[0] + phases[1]) * total_steps
    if step < warm:
        return 1.0
    if step >= prune_end:
        return final_density
    # cubic sparsity ramp: s(t) = s_f * (1 - (1 - t_norm)^3)
    t_norm = (step - warm) / max(1.0, prune_end - warm)
    s_final = 1.0 - final_density
    sparsity = s_final * (1.0 - (1.0 - t_norm) ** 3)
    return 1.0 - sparsity


def magnitude_masks(w: torch.Tensor, density: float) -> torch.Tensor:
    """Keep the top-``density`` fraction of |w| (ties at the threshold kept)."""
    if density >= 1.0:
        return torch.ones_like(w, dtype=torch.float32)
    n = w.numel()
    k = max(1, int(round(n * density)))
    flat = w.abs().reshape(-1)
    thresh = torch.sort(flat).values[n - k]   # k-th largest magnitude
    return (w.abs() >= thresh).to(torch.float32)


def block_magnitude_masks(w: torch.Tensor, density: float, block_oc: int = 8,
                          block_k: int = 128) -> torch.Tensor:
    """Prune a conv kernel (KW, IC, OC) by whole (block_oc x block_k) tiles
    of its flattened (OC, IC*KW) matmul operand, ranked by L1 norm, so the
    tile density equals the weight density (the reference's TPU co-design
    variant, beyond the paper)."""
    if density >= 1.0:
        return torch.ones_like(w, dtype=torch.float32)
    kw, ic, oc = w.shape
    flat = w.permute(2, 1, 0).reshape(oc, ic * kw)
    f = torch.nn.functional.pad(flat, (0, (-ic * kw) % block_k,
                                       0, (-oc) % block_oc))
    r, c = f.shape[0] // block_oc, f.shape[1] // block_k
    tile_score = f.reshape(r, block_oc, c, block_k).abs().sum(dim=(1, 3))
    n_tiles = r * c
    k = max(1, int(round(n_tiles * density)))
    thresh = torch.sort(tile_score.reshape(-1)).values[n_tiles - k]
    tile_mask = (tile_score >= thresh).to(torch.float32)          # (r, c)
    m = tile_mask[:, None, :, None].expand(r, block_oc, c, block_k)
    m = m.reshape(f.shape)[:oc, :ic * kw]
    return m.reshape(oc, ic, kw).permute(2, 1, 0).contiguous()


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


def mask_density(masks: Dict) -> Dict[str, float]:
    """Fraction of kept weights per layer, keyed 'conv1'..., 'fc1'..."""
    # numpy's float32 mean, as the reference computes it
    def mean(m) -> float:
        return float(torch.as_tensor(m).detach().cpu().numpy().mean())

    out = {}
    for i, m in enumerate(masks["conv"]):
        out[f"conv{i + 1}"] = mean(m)
    for i, m in enumerate(masks["fc"]):
        out[f"fc{i + 1}"] = mean(m)
    return out
