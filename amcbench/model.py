"""The model of a configuration, made from the seed: weights, masks and LIF
parameters on the device, and the raw tensors both sides receive.

The weights are drawn on the device by one ``torch.Generator`` call (He
scaling per layer, as the paper's model is initialised), cast to the
configuration's dtype, and pruned by magnitude to the configuration's
per-layer densities (the top ``round(n * density)`` magnitudes kept, ties at
the threshold kept, as the paper's L1 pruning keeps them).  The program gets
host copies in its own parameter layout; the reference gets the same raw
tensors and works the effective weights out itself.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class Layer:
    """One weighted layer's raw tensors, in the configuration's dtype."""

    kind: str                 # "conv" (w: (KW, IC, OC)) or "fc" (w: (IN, OUT))
    w: torch.Tensor
    mask: torch.Tensor        # 0/1 in the weights' dtype
    alpha_logit: torch.Tensor  # (OC, 1) for a conv, (OUT,) for an FC
    theta: torch.Tensor
    v_th: torch.Tensor


@dataclasses.dataclass
class Model:
    spec: Dict[str, Any]      # the configuration's "model" group
    dtype: torch.dtype
    layers: List[Layer]

    def convs(self) -> List[Layer]:
        return [l for l in self.layers if l.kind == "conv"]

    def fcs(self) -> List[Layer]:
        return [l for l in self.layers if l.kind == "fc"]


def shapes(spec: Dict[str, Any]):
    """[(kind, weight shape, He fan-in, LIF shape)] in graph order."""
    out = []
    for kw, ic, oc in spec["conv_specs"]:
        out.append(("conv", (kw, ic, oc), kw * ic, (oc, 1)))
    for din, dout in spec["fc_specs"]:
        out.append(("fc", (din, dout), din, (dout,)))
    return out


def magnitude_mask(w: torch.Tensor, density: float) -> torch.Tensor:
    """Keep the top ``round(n * density)`` of |w| (at least one; ties at the
    threshold kept), as 0/1 in ``w``'s dtype."""
    if density >= 1.0:
        return torch.ones_like(w)
    flat = w.abs().reshape(-1).float()
    n = flat.numel()
    k = max(1, int(round(n * density)))
    thresh = torch.sort(flat).values[n - k]
    return (w.abs().float() >= thresh).to(w.dtype)


def make_model(config: Dict[str, Any], seed: int, device) -> Model:
    """The configuration's model from ``seed`` on ``device``."""
    spec = config["model"]
    dtype = DTYPES[config["dtype"]]
    plan = shapes(spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    total = sum(math.prod(s) for _, s, _, _ in plan)
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    alpha = min(max(float(spec["lif_alpha"]), 1e-4), 1 - 1e-4)
    logit = math.log(alpha / (1.0 - alpha))
    layers = []
    at = 0
    names = [f"conv{i + 1}" for i in range(len(spec["conv_specs"]))] + [
        f"fc{i + 1}" for i in range(len(spec["fc_specs"]))]
    for name, (kind, shape, fan_in, lif_shape) in zip(names, plan):
        n = math.prod(shape)
        w = (z[at:at + n].view(shape) * math.sqrt(2.0 / fan_in)).to(dtype)
        at += n
        full = lambda v: torch.full(lif_shape, v, dtype=dtype, device=device)  # noqa: E731
        layers.append(Layer(kind=kind, w=w,
                            mask=magnitude_mask(w, float(config["densities"][name])),
                            alpha_logit=full(logit), theta=full(spec["lif_theta"]),
                            v_th=full(spec["lif_v_th"])))
    return Model(spec=spec, dtype=dtype, layers=layers)


def snn_config(spec: Dict[str, Any]):
    """The program's ``SNNConfig`` for the configuration's model group."""
    from repro_torch.models.snn import SNNConfig

    return SNNConfig(conv_specs=tuple(tuple(c) for c in spec["conv_specs"]),
                     fc_specs=tuple(tuple(f) for f in spec["fc_specs"]),
                     pool=spec["pool"], input_width=spec["input_width"],
                     timesteps=spec["timesteps"], n_classes=spec["n_classes"],
                     readout=spec["readout"], lif_alpha=spec["lif_alpha"],
                     lif_theta=spec["lif_theta"], lif_v_th=spec["lif_v_th"])


def program_params(model: Model):
    """``(params, masks)`` in the program's layout, on the host (as its
    ``init_snn`` and ``make_mask_pytree`` give them)."""
    from repro_torch.core.lif import LIFParams

    params: Dict[str, list] = {"conv": [], "fc": []}
    masks: Dict[str, list] = {"conv": [], "fc": []}
    for l in model.layers:
        lif = LIFParams(alpha_logit=l.alpha_logit.cpu(), theta=l.theta.cpu(),
                        v_th=l.v_th.cpu())
        params[l.kind].append({"w": l.w.cpu(), "lif": lif})
        masks[l.kind].append(l.mask.cpu())
    return params, masks
