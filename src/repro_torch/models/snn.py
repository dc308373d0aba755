"""The paper's 5-layer SNN classifier (Fig. 7, shapes fixed by Table II).

    input (T, 2, 128) binary sigma-delta frames
      Conv1 k=11,  2->16, same pad  + LIF -> MaxPool2
      Conv2 k=11, 16->32, same pad  + LIF -> MaxPool2
      Conv3 k=5,  32->64, same pad  + LIF -> MaxPool2
      FC1   1024 -> 128 (weight-mask method) + LIF
      FC2    128 -> 11
    readout: sum over T of FC2 input currents ("current_sum").

Port of ``repro/models/snn.py``.  Params are a nested dict of torch
tensors, ``{"conv": [{"w": (KW, IC, OC), "lif": LIFParams}], "fc":
[{"w": (IN, OUT), "lif": LIFParams}]}`` — the reference's pytree with
torch leaves (:mod:`repro_torch.convert` carries reference weights over).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lif import init_lif_params
from repro_torch.core.sparse_format import coo_from_dense

__all__ = ["SNNConfig", "init_snn", "sparsify_params"]


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    """Paper model by default; reducible for smoke tests."""

    conv_specs: Tuple[Tuple[int, int, int], ...] = ((11, 2, 16), (11, 16, 32), (5, 32, 64))
    pool: int = 2
    fc_specs: Tuple[Tuple[int, int], ...] = ((1024, 128), (128, 11))
    input_width: int = 128
    timesteps: int = 8           # = sigma-delta OSR
    n_classes: int = 11
    readout: str = "current_sum"  # or "spike_count"
    lif_alpha: float = 0.9
    lif_theta: float = 1.0
    lif_v_th: float = 1.0

    def validate(self) -> "SNNConfig":
        w = self.input_width
        ic = self.conv_specs[0][1]
        for kw, c_in, c_out in self.conv_specs:
            if c_in != ic:
                raise ValueError(f"conv chain broken: {c_in} != {ic}")
            ic = c_out
            w = w // self.pool
        if self.fc_specs[0][0] != ic * w:
            raise ValueError(f"FC1 input {self.fc_specs[0][0]} != flattened "
                             f"conv output {ic * w}")
        if self.fc_specs[-1][1] != self.n_classes:
            raise ValueError(f"last FC width {self.fc_specs[-1][1]} != "
                             f"n_classes {self.n_classes}")
        return self


def init_snn(seed: int, cfg: SNNConfig) -> Dict[str, Any]:
    """He-style init from a numpy seed (the reference draws from a jax key,
    so the two give different weights; parity tests carry the reference's
    weights over with :func:`repro_torch.convert.params_from_numpy`)."""
    cfg.validate()
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {"conv": [], "fc": []}
    for kw, ic, oc in cfg.conv_specs:
        w = rng.standard_normal((kw, ic, oc)) * np.sqrt(2.0 / (kw * ic))
        params["conv"].append({
            "w": torch.from_numpy(w.astype(np.float32)),
            "lif": init_lif_params((oc, 1), cfg.lif_alpha, cfg.lif_theta,
                                   cfg.lif_v_th),
        })
    for din, dout in cfg.fc_specs:
        w = rng.standard_normal((din, dout)) * np.sqrt(2.0 / din)
        params["fc"].append({
            "w": torch.from_numpy(w.astype(np.float32)),
            "lif": init_lif_params((dout,), cfg.lif_alpha, cfg.lif_theta,
                                   cfg.lif_v_th),
        })
    return params


def _masked(w: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return w if mask is None else w * mask


def sparsify_params(params: Dict[str, Any], masks: Optional[Dict[str, Any]] = None):
    """Convert (optionally masked) dense params into the COO inference form."""
    sp: Dict[str, list] = {"conv": [], "fc": []}
    for li, layer in enumerate(params["conv"]):
        w = _masked(layer["w"], masks["conv"][li] if masks else None)
        sp["conv"].append({"coo": coo_from_dense(w.detach().cpu().numpy()),
                           "lif": layer["lif"]})
    for fi, layer in enumerate(params["fc"]):
        w = _masked(layer["w"], masks["fc"][fi] if masks else None)
        sp["fc"].append({"w": w, "lif": layer["lif"]})
    return sp
