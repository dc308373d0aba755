"""Carry the reference's weights across as nested numpy.

The reference draws its weights from jax PRNG keys, which torch cannot
reproduce, so parity checks give both packages the same numbers: the
reference's param pytree as nested numpy (each LIFParams as a dict
``{"alpha_logit", "theta", "v_th"}``) becomes the port's params here.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.lif import LIFParams

__all__ = ["params_from_numpy", "masks_from_numpy"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lif(d) -> LIFParams:
    return LIFParams(alpha_logit=_t(d["alpha_logit"]), theta=_t(d["theta"]),
                     v_th=_t(d["v_th"]))


def params_from_numpy(params_np: Dict[str, Any]) -> Dict[str, Any]:
    """``{"conv"/"fc": [{"w", "lif": {...}}]}`` numpy -> port params (CPU)."""
    return {group: [{"w": _t(layer["w"]), "lif": _lif(layer["lif"])}
                    for layer in params_np[group]]
            for group in ("conv", "fc")}


def masks_from_numpy(masks_np: Dict[str, Any]) -> Dict[str, Any]:
    """``{"conv"/"fc": [mask]}`` numpy -> port masks (CPU)."""
    return {group: [_t(m) for m in masks_np[group]] for group in ("conv", "fc")}
