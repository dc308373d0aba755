"""Offline float -> fixed-point conversion (paper §IV-C.2, FPGA datapath).

Port of ``repro/fixed/quantize.py`` (numpy at bind time; the fake-quant
value of :class:`FixedQuantFn` in torch float32).  This module is the
*bind-time* half of the ``fixed`` backend: it turns LSQ-trained (or
calibrated) float weights and per-neuron LIF parameters into the integer
constants the hardware datapath consumes.  The runtime halves — the torch
cells in :mod:`repro_torch.fixed.backend` and the NumPy golden interpreter
in :mod:`repro_torch.fixed.golden` — both consume the structures built
here, so the conversion is a single source of truth and any
backend/golden disagreement is a *datapath* bug, never a conversion skew.

Number formats (Jelly-style Qm.n):

* weights      — int8/int16 codes; one per-tensor step size ``s`` per
  layer (LSQ-trained, or max-abs calibrated when no LSQ state exists).
* currents     — int32 accumulators in *code units* (spike in {0,1} times
  weight code), i.e. one code unit = ``s``.
* membrane     — int16, in *membrane units* of ``s * 2**acc_shift``:
  currents enter the membrane through an arithmetic right shift chosen so
  the quantized threshold lands near ``TARGET_VTH`` (12-bit headroom
  inside the int16 membrane).
* leak         — ``v - (v >> k)`` approximates ``alpha * v`` with
  ``k = round(-log2(1 - alpha))`` per neuron (shift-based decay).

All conversion arithmetic is float32 so codes derived here and
fake-quant values agree bit for bit: ``round(fakequant(w) / s) == clip(round(w / s))`` exactly, because
``fakequant(w) / s`` recovers the integer code without rounding error in
float32 for |code| < 2**23.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.train.lsq import make_serving_quant_fn

__all__ = [
    "I16_MIN",
    "I16_MAX",
    "TARGET_VTH",
    "FIXED_DEFAULT_BITS",
    "QuantizedLayer",
    "FixedLIF",
    "FixedQuantFn",
    "calibrate_step",
    "quantize_codes",
    "lif_to_fixed",
    "derive_fixed_layer",
    "fixed_logit_scale",
    "serving_quant_fn",
    "assignment_uses_fixed",
]

I16_MIN = -(2 ** 15)
I16_MAX = 2 ** 15 - 1
# Quantized-threshold target in membrane units: leaves ~3 bits of int16
# headroom above threshold before the membrane write-back saturates.
TARGET_VTH = 4096
MAX_ACC_SHIFT = 24
MAX_LEAK_SHIFT = 15
FIXED_DEFAULT_BITS = 16
_STEP_FLOOR = 1e-8


@dataclasses.dataclass(frozen=True)
class QuantizedLayer:
    """Integer weight codes plus the step size they were derived with.

    The (codes, step) pair travels together: the membrane/threshold
    constants of :class:`FixedLIF` are always derived from *this* step, so
    the datapath stays self-consistent even if an equivalent
    representation with a different step produced the same float weights.
    """

    codes: np.ndarray  # int8 (bits<=8) or int16 codes, original weight shape
    step: float        # float32-exact step size (one code unit)
    bits: int


@dataclasses.dataclass(frozen=True)
class FixedLIF:
    """Per-neuron integer LIF constants (FPGA register file contents)."""

    leak_shift: np.ndarray  # int32, per neuron: alpha*v ~= v - (v >> k)
    vth: np.ndarray         # int32 threshold, membrane units
    theta: np.ndarray       # int32 soft-reset amount, membrane units
    acc_shift: int          # current (code units) >> acc_shift -> membrane
    mem_scale: float        # float value of one membrane unit


def _np(x, dtype=None) -> np.ndarray:
    """A tensor (any device) or array as numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _f32(x) -> np.ndarray:
    return _np(x, np.float32)


def calibrate_step(w, bits: int = FIXED_DEFAULT_BITS) -> float:
    """Max-abs step size for layers without trained LSQ state.

    Returns a float32-exact value with a floor so all-zero (fully pruned)
    layers still get a usable format instead of a degenerate zero step.
    """
    qmax = 2 ** (bits - 1) - 1
    w = _f32(w)
    peak = float(np.max(np.abs(w))) if w.size else 0.0
    return float(np.float32(max(peak / qmax, _STEP_FLOOR)))


def quantize_codes(w_eff, step: float, bits: int = FIXED_DEFAULT_BITS) -> np.ndarray:
    """Float weights -> integer codes (round-half-even, saturating clip)."""
    qmax = 2 ** (bits - 1) - 1
    qmin = -(2 ** (bits - 1))
    codes = np.clip(np.round(_f32(w_eff) / np.float32(step)), qmin, qmax)
    return codes.astype(np.int8 if bits <= 8 else np.int16)


def lif_to_fixed(lif, step: float) -> FixedLIF:
    """Convert per-neuron float LIF parameters to the integer register set.

    ``step`` is the layer's weight step size (one current code unit).  The
    accumulator shift is chosen per layer so the mean quantized threshold
    lands near :data:`TARGET_VTH` membrane units, keeping thresholds and
    soft-reset amounts well inside int16 while preserving sub-threshold
    resolution.
    """
    alpha = 1.0 / (1.0 + np.exp(-_np(lif.alpha_logit, np.float64)))
    one_minus = np.maximum(1.0 - alpha, 2.0 ** -20)
    leak_shift = np.clip(np.round(-np.log2(one_minus)), 0, MAX_LEAK_SHIFT)
    leak_shift = leak_shift.astype(np.int32)

    vth_units = _np(lif.v_th, np.float64) / float(step)
    mean_vth = float(np.mean(np.abs(vth_units)))
    ratio = max(mean_vth, 1.0) / TARGET_VTH
    acc_shift = int(np.clip(np.floor(np.log2(ratio)) if ratio > 1.0 else 0,
                            0, MAX_ACC_SHIFT))
    scale = float(2 ** acc_shift)
    vth_q = np.round(vth_units / scale).astype(np.int32)
    theta_q = np.round(
        _np(lif.theta, np.float64) / float(step) / scale).astype(np.int32)
    return FixedLIF(leak_shift=leak_shift, vth=vth_q, theta=theta_q,
                    acc_shift=acc_shift, mem_scale=float(step) * scale)


class FixedQuantFn:
    """Serving ``quant_fn`` for the fixed tier.

    Plays both roles the bind paths need:

    * ``__call__(w)`` — fake-quantization (a float32 torch tensor),
      value-identical to :func:`repro_torch.train.lsq.lsq_fake_quant`,
      so the plan compiler's
      content hashing and any float backend racing against ``fixed`` see
      exactly the weights the integer datapath represents.  Like
      :func:`make_serving_quant_fn` it walks the weighted layers in graph
      order via a stateful index (wrapping modulo the layer count), so use
      a fresh instance per bind *or* rely on whole-pass alignment.
    * ``step_for(group, index, w)`` — stateless per-layer step lookup used
      by the fixed backend factory and the golden builder: the trained LSQ
      step when available, max-abs calibration from ``w`` otherwise.
    """

    def __init__(self, lsq_scales: Optional[Dict] = None,
                 bits: int = FIXED_DEFAULT_BITS):
        if bits not in (8, 16):
            raise ValueError(f"fixed tier supports 8- or 16-bit weights, got {bits}")
        self.lsq_scales = lsq_scales
        self.bits = int(bits)
        self._flat = (list(lsq_scales["conv"]) + list(lsq_scales["fc"])
                      if lsq_scales is not None else None)
        self._idx = 0

    def reset(self) -> None:
        """Rewind the layer-order index (start of a fresh bind pass)."""
        self._idx = 0

    def step_for(self, group: str, index: int, w) -> float:
        if self.lsq_scales is None:
            return calibrate_step(w, self.bits)
        s = float(np.float32(float(self.lsq_scales[group][index])))
        return float(np.float32(max(s, _STEP_FLOOR)))

    def __call__(self, w):
        if self._flat is None:
            s = calibrate_step(w, self.bits)
        else:
            s = float(np.float32(float(self._flat[self._idx % len(self._flat)])))
            s = float(np.float32(max(s, _STEP_FLOOR)))
            self._idx += 1
        qmax = 2 ** (self.bits - 1) - 1
        qmin = -(2 ** (self.bits - 1))
        w = torch.as_tensor(w, dtype=torch.float32)
        # divide by a tensor on w's device: a CPU-scalar divisor would be
        # turned into a multiplication by its reciprocal on the card
        s_t = torch.tensor(s, dtype=torch.float32, device=w.device)
        return torch.clamp(torch.round(w / s_t), qmin, qmax) * s_t


def _group_of(kind_or_group: str) -> str:
    # accept either a layer-graph kind ("conv_lif"/"fc_lif") or the param
    # group name ("conv"/"fc")
    if kind_or_group in ("conv", "conv_lif"):
        return "conv"
    if kind_or_group in ("fc", "fc_lif"):
        return "fc"
    raise ValueError(f"no fixed-point conversion for layer kind {kind_or_group!r}")


def derive_fixed_layer(group: str, index: int, w, mask=None, quant_fn=None,
                       w_eff=None, bits: Optional[int] = None) -> QuantizedLayer:
    """Derive one layer's integer weight codes.

    ``w_eff`` (the masked + fake-quantized float weights) may be passed in
    when already computed (plan-compiler artifact); otherwise it is derived
    here exactly the way :func:`repro_torch.models.graph.effective_weight`
    does.
    The step size comes from ``quant_fn.step_for`` when a
    :class:`FixedQuantFn` drives the bind, else from max-abs calibration of
    ``w_eff`` — in both cases ``round(w_eff / step)`` recovers the integer
    codes exactly (see module docstring).
    """
    group = _group_of(group)
    masked = _np(w)
    if mask is not None:
        masked = masked * _np(mask)
    if w_eff is None:
        w_eff = _np(quant_fn(masked)) if quant_fn is not None else masked
    else:
        w_eff = _np(w_eff)
    if isinstance(quant_fn, FixedQuantFn):
        step = quant_fn.step_for(group, index, masked)
        bits = quant_fn.bits
    else:
        bits = int(bits or FIXED_DEFAULT_BITS)
        step = calibrate_step(w_eff, bits)
    return QuantizedLayer(codes=quantize_codes(w_eff, step, bits),
                          step=step, bits=bits)


def fixed_logit_scale(params, cfg, masks=None, quant_fn=None) -> float:
    """Float value of one logit unit of the fixed datapath.

    With a ``current_sum`` readout the fixed logits are int32 sums of the
    last FC layer's currents in that layer's code units, so multiplying by
    its step size lands them on the float backends' logit scale (argmax is
    invariant either way).  ``spike_count`` readouts already emit unit
    spikes — scale 1.  Exact for :class:`FixedQuantFn` and for plain
    calibration; for other quant closures the calibration here matches the
    backend's because both calibrate from the same effective weights.
    """
    if cfg.readout != "current_sum":
        return 1.0
    i = len(params["fc"]) - 1
    w = _np(params["fc"][i]["w"])
    if masks is not None:
        w = w * _np(masks["fc"][i])
    if isinstance(quant_fn, FixedQuantFn):
        return quant_fn.step_for("fc", i, w)
    return calibrate_step(w, FIXED_DEFAULT_BITS)


def assignment_uses_fixed(assignment) -> bool:
    """True when a plan assignment routes any layer to the fixed backend."""
    if isinstance(assignment, str):
        return assignment == "fixed"
    if isinstance(assignment, dict):
        return "fixed" in assignment.values()
    return False


def serving_quant_fn(lsq_scales, quant_bits: int = FIXED_DEFAULT_BITS,
                     assignment=None):
    """The one rule for which quant_fn a serving bind gets.

    Fixed assignments always get a :class:`FixedQuantFn` (it calibrates
    when no LSQ state exists); float assignments keep the existing
    behavior — the trained fake-quant closure with LSQ state, nothing
    without.  Engine and registry share this helper so their plan digests
    agree and prewarmed caches hit.
    """
    if assignment_uses_fixed(assignment):
        return FixedQuantFn(lsq_scales, quant_bits)
    if lsq_scales is None:
        return None
    return make_serving_quant_fn(lsq_scales, quant_bits)
