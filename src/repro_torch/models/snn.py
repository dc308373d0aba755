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
``init_snn(seed, cfg, dtype=torch.bfloat16)`` gives the bf16 model; every
backend then keeps the reference's dtype at each point
(:mod:`repro_torch.models.graph`).

Execution lives in :mod:`repro_torch.models.graph`; the reference's legacy
entry points stay as deprecated shims that warn ``DeprecationWarning``:

* ``snn_forward``        -> ``compile_snn(cfg).apply(..., backend="dense")``
* ``snn_forward_batch``  -> ``compile_snn(cfg).apply_batch(..., backend="dense")``
* ``snn_forward_sparse`` -> ``compile_snn(cfg).apply(..., backend="goap")``
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lif import init_lif_params
from repro_torch.core.sparse_format import coo_from_dense
from repro_torch.tree import tree_leaves

__all__ = ["SNNConfig", "init_snn", "snn_forward", "snn_forward_batch",
           "snn_forward_sparse", "param_count", "sparsify_params",
           "density_report"]


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

    def feature_widths(self) -> List[int]:
        """Spatial width after each conv+pool stage."""
        w = self.input_width
        widths = []
        for _ in self.conv_specs:
            w = w // self.pool
            widths.append(w)
        return widths

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


def init_snn(seed: int, cfg: SNNConfig, dtype=torch.float32) -> Dict[str, Any]:
    """He-style init from a numpy seed, in ``dtype`` (float32 or bfloat16).

    The weights are drawn in f32 and cast, as the LIF parameters are made
    in ``dtype`` (the reference draws from a jax key, so the two give
    different weights; parity tests carry the reference's weights over
    with :func:`repro_torch.convert.params_from_numpy`)."""
    cfg.validate()
    rng = np.random.default_rng(seed)
    params: Dict[str, Any] = {"conv": [], "fc": []}
    for kw, ic, oc in cfg.conv_specs:
        w = rng.standard_normal((kw, ic, oc)) * np.sqrt(2.0 / (kw * ic))
        params["conv"].append({
            "w": torch.from_numpy(w.astype(np.float32)).to(dtype),
            "lif": init_lif_params((oc, 1), cfg.lif_alpha, cfg.lif_theta,
                                   cfg.lif_v_th, dtype),
        })
    for din, dout in cfg.fc_specs:
        w = rng.standard_normal((din, dout)) * np.sqrt(2.0 / din)
        params["fc"].append({
            "w": torch.from_numpy(w.astype(np.float32)).to(dtype),
            "lif": init_lif_params((dout,), cfg.lif_alpha, cfg.lif_theta,
                                   cfg.lif_v_th, dtype),
        })
    return params


def param_count(params) -> int:
    """Number of scalars over every leaf (weights and LIF parameters)."""
    return sum(int(np.prod(p.shape)) for p in tree_leaves(params))


def _masked(w: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    return w if mask is None else w * mask


def sparsify_params(params: Dict[str, Any], masks: Optional[Dict[str, Any]] = None):
    """Convert (optionally masked) dense params into the COO inference form."""
    sp: Dict[str, list] = {"conv": [], "fc": []}
    for li, layer in enumerate(params["conv"]):
        w = _masked(layer["w"], masks["conv"][li] if masks else None)
        sp["conv"].append({"coo": coo_from_dense(w.detach().float().cpu().numpy()),
                           "lif": layer["lif"]})
    for fi, layer in enumerate(params["fc"]):
        w = _masked(layer["w"], masks["fc"][fi] if masks else None)
        sp["fc"].append({"w": w, "lif": layer["lif"]})
    return sp


def density_report(params, masks=None) -> Dict[str, float]:
    """Fraction of non-zero (masked) weights per layer."""
    def density(w, mask) -> float:
        w = _masked(w, mask).detach().float().cpu().numpy()
        return float((w != 0).mean())

    out = {}
    for li, layer in enumerate(params["conv"]):
        out[f"conv{li + 1}"] = density(layer["w"], masks["conv"][li] if masks else None)
    for fi, layer in enumerate(params["fc"]):
        out[f"fc{fi + 1}"] = density(layer["w"], masks["fc"][fi] if masks else None)
    return out


def _deprecated(old: str, new: str) -> None:
    warnings.warn(f"{old} is deprecated; use {new} (see repro_torch.api)",
                  DeprecationWarning, stacklevel=3)


def snn_forward(params, frames, cfg: SNNConfig, masks=None, quant_fn=None, *,
                device=None) -> torch.Tensor:
    """Deprecated: use ``compile_snn(cfg).apply(..., backend="dense")``."""
    from repro_torch.models.graph import compile_snn

    _deprecated("snn_forward", 'SNNProgram.apply(..., backend="dense")')
    return compile_snn(cfg).apply(params, frames, "dense", masks=masks,
                                  quant_fn=quant_fn, device=device)


def snn_forward_batch(params, frames_b, cfg: SNNConfig, masks=None,
                      quant_fn=None, *, device=None) -> torch.Tensor:
    """Deprecated: use ``compile_snn(cfg).apply_batch(..., backend="dense")``."""
    from repro_torch.models.graph import compile_snn

    _deprecated("snn_forward_batch", 'SNNProgram.apply_batch(..., backend="dense")')
    return compile_snn(cfg).apply_batch(params, frames_b, "dense", masks=masks,
                                        quant_fn=quant_fn, device=device)


def snn_forward_sparse(sparse_params, frames, cfg: SNNConfig, *,
                       device=None) -> torch.Tensor:
    """Deprecated: use ``compile_snn(cfg).apply(..., backend="goap")``; takes
    the COO inference form of :func:`sparsify_params`."""
    from repro_torch.models.graph import compile_snn

    _deprecated("snn_forward_sparse", 'SNNProgram.apply(..., backend="goap")')
    return compile_snn(cfg).apply(sparse_params, frames, "goap", device=device)
