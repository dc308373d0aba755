"""The ``fixed`` execution backend: integer inference in torch.

Port of ``repro/fixed/backend.py``.  Runtime datapath per timestep,
mirrored op for op by the NumPy golden in :mod:`repro_torch.fixed.golden`:

conv/fc current:   int32 sum of int weight codes gated by binary input
                   spikes (im2col matmul for conv, vector-matrix for FC),
                   in code units.
membrane update:   v32   = sign_extend(v16)
                   v_dec = v32 - (v32 >> leak_shift)          (alpha decay)
                   v_acc = v_dec + (current >> acc_shift)     (to membrane units)
                   s     = (v_acc > vth)                      (strict compare)
                   v16'  = sat16(v_acc - theta * s)           (soft reset +
                                                              saturating write-back)

Spikes are int32 {0, 1}; FC cells emit ``(spikes, currents)`` with the
raw int32 currents, so the common ``current_sum`` readout (``zeros_like``
keeps the dtype) sums int32 logits (one logit unit = the last FC layer's
step size, :func:`repro_torch.fixed.quantize.fixed_logit_scale`).

The integer products.  Torch has no int32 matrix product on CUDA, so
codes and spikes are multiplied as float64 and converted back to int32.
That is exact: every product is a code times 0 or 1, and every partial
sum is an integer of magnitude at most 1024 * 32768 = 2**25 (FC1 of the
paper model at 16 bits, the widest sum here), far below 2**53, the
largest range of consecutive integers float64 holds, whatever order the
library sums in.  float32 would not be exact: FC1 at 16 bits can pass
2**24.  The shifts are ``>>`` on signed int32, arithmetic, one shift
amount per neuron.

Binding derives the codes in numpy from concrete weights (on the host);
the bound cells run on the plan's device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.goap import build_shift_buffer
from repro_torch.core.saocds import pad_same
from repro_torch.fixed.quantize import (
    I16_MAX,
    I16_MIN,
    FixedLIF,
    derive_fixed_layer,
    lif_to_fixed,
)
from repro_torch.models.graph import (
    KIND_CONV,
    KIND_FC,
    LayerCell,
    _artifact,
    _spikes_of,
    register_backend,
)

__all__ = ["fixed_lif_step", "register"]


class _LifConsts(NamedTuple):
    leak: torch.Tensor   # int32 per-neuron leak shift
    vth: torch.Tensor    # int32 threshold (membrane units)
    theta: torch.Tensor  # int32 soft-reset (membrane units)
    acc_shift: int       # one shift amount for the layer


def _lif_consts(flif: FixedLIF, device) -> _LifConsts:
    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return _LifConsts(leak=t(flif.leak_shift), vth=t(flif.vth),
                      theta=t(flif.theta), acc_shift=int(flif.acc_shift))


def fixed_lif_step(v16: torch.Tensor, acc32: torch.Tensor, L: _LifConsts):
    """One integer LIF update; returns (v16_next, spikes int32)."""
    v32 = v16.to(torch.int32)
    v_dec = v32 - (v32 >> L.leak)
    v_acc = v_dec + (acc32 >> L.acc_shift)
    s = (v_acc > L.vth).to(torch.int32)
    v_next = torch.clamp(v_acc - L.theta * s, I16_MIN, I16_MAX).to(torch.int16)
    return v_next, s


def _int_matmul(a64: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of float64 codes and 0/1 spikes (see above)."""
    return torch.matmul(a64, b.to(torch.float64)).to(torch.int32)


def _quantized(spec, layer_params, mask, quant_fn, artifacts):
    """The layer's QuantizedLayer (cached) and FixedLIF (rebuilt per bind:
    the artifact key hashes weights, not LIF parameters)."""
    group = "conv" if spec.kind == KIND_CONV else "fc"
    w_eff = None
    if artifacts is not None and artifacts.get("w_eff") is not None:
        w_eff = np.asarray(artifacts["w_eff"])
    bits = getattr(quant_fn, "bits", None)
    ql = _artifact(artifacts, f"fixed_q{bits or 'cal'}", lambda: derive_fixed_layer(
        group, spec.index, layer_params["w"], mask=mask, quant_fn=quant_fn,
        w_eff=w_eff))
    return ql, lif_to_fixed(layer_params["lif"], ql.step)


def _fixed_conv(spec, layer_params, *, cfg, mask=None, quant_fn=None,
                artifacts=None, device=None) -> LayerCell:
    ql, flif = _quantized(spec, layer_params, mask, quant_fn, artifacts)
    L = _lif_consts(flif, device)
    kw, oc = spec.kw, spec.oc
    # W'(OC, IC*KW) im2col layout, as the dense oracle
    wmat = torch.as_tensor(
        np.transpose(ql.codes, (2, 1, 0)).reshape(oc, -1).astype(np.float64),
        device=device)

    def init_state(x_t):
        return torch.zeros((x_t.shape[0], oc, x_t.shape[-1]),
                           dtype=torch.int16, device=x_t.device)

    def step(v, x_t):
        x = _spikes_of(x_t).to(torch.float64)
        acc = _int_matmul(wmat, build_shift_buffer(pad_same(x, kw), kw))
        return fixed_lif_step(v, acc, L)

    return LayerCell(init_state=init_state, step=step)


def _fixed_fc(spec, layer_params, *, cfg, mask=None, quant_fn=None,
              artifacts=None, device=None) -> LayerCell:
    ql, flif = _quantized(spec, layer_params, mask, quant_fn, artifacts)
    L = _lif_consts(flif, device)
    wmat = torch.as_tensor(ql.codes.astype(np.float64), device=device)

    def init_state(x_t):
        s = _spikes_of(x_t)
        return torch.zeros((s.shape[0], wmat.shape[1]), dtype=torch.int16,
                           device=s.device)

    def step(v, x_t):
        s = _spikes_of(x_t)
        cur = _int_matmul(s.reshape(s.shape[0], -1).to(torch.float64), wmat)
        v_next, out = fixed_lif_step(v, cur, L)
        return v_next, (out, cur)

    return LayerCell(init_state=init_state, step=step)


def register() -> None:
    """Register the fixed backend (idempotent; called lazily by get_backend)."""
    register_backend("fixed", KIND_CONV, _fixed_conv)
    register_backend("fixed", KIND_FC, _fixed_fc)


register()
