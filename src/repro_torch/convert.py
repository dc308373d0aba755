"""Carry the reference's weights across as nested numpy.

The reference draws its weights from jax PRNG keys, which torch cannot
reproduce, so parity checks give both packages the same numbers: the
reference's param pytree as nested numpy (each LIFParams as a dict
``{"alpha_logit", "theta", "v_th"}``) becomes the port's params here.
Every leaf keeps its dtype: a bf16 SNN (the reference's ``init_snn(key,
cfg, dtype=jnp.bfloat16)``) crosses as bf16, as do the language-model
zoo's trees (``init_lm`` / ``init_whisper`` params and decode states).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.lif import LIFParams
from repro_torch.tree import tree_map

__all__ = ["params_from_numpy", "masks_from_numpy", "lm_params_from_numpy",
           "lm_state_from_numpy"]


def _t(a) -> torch.Tensor:
    return _leaf_from_numpy(a, None)


def _lif(d) -> LIFParams:
    return LIFParams(alpha_logit=_t(d["alpha_logit"]), theta=_t(d["theta"]),
                     v_th=_t(d["v_th"]))


def params_from_numpy(params_np: Dict[str, Any]) -> Dict[str, Any]:
    """``{"conv"/"fc": [{"w", "lif": {...}}]}`` numpy -> port params (CPU),
    each leaf in its dtype (float32 or bfloat16)."""
    return {group: [{"w": _t(layer["w"]), "lif": _lif(layer["lif"])}
                    for layer in params_np[group]]
            for group in ("conv", "fc")}


def masks_from_numpy(masks_np: Dict[str, Any]) -> Dict[str, Any]:
    """``{"conv"/"fc": [mask]}`` numpy -> port masks (CPU), each in its dtype."""
    return {group: [_t(m) for m in masks_np[group]] for group in ("conv", "fc")}


def _leaf_from_numpy(a, device) -> torch.Tensor:
    """One numpy leaf -> a tensor of the same dtype.  A bf16 leaf (the
    ``ml_dtypes`` type jax hands out, which torch cannot read) crosses
    through its 16-bit view; ``ml_dtypes`` itself is not imported."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t if device is None else t.to(device)


def lm_params_from_numpy(tree, device=None):
    """The reference's ``init_lm`` / ``init_whisper`` params as nested numpy
    (dicts and lists of arrays) -> the port's tree, each leaf keeping its
    dtype, on ``device`` (default: the CPU)."""
    return tree_map(lambda a: _leaf_from_numpy(a, device), tree)


# a reference decode state (``init_decode_state`` / ``lm_prefill`` /
# ``init_whisper_decode_state`` layout: bf16 or int8 caches, f32 scales,
# int32 lengths) crosses the same way
lm_state_from_numpy = lm_params_from_numpy
